"""CUDA kernels of the PyTorch port against their plain torch versions.

Needs a CUDA card: every test skips without one (the kernels have no CPU
mode).  The file imports neither JAX nor the JAX package, so on a machine
without JAX it runs as
``python -m pytest --noconftest tests/test_torch_cuda.py`` from the
repository root (tests/conftest.py imports JAX).

Tolerances: 1e-12 relative to max|H| (1e-12 for Z), for the one- and the
multi-bulge sweep; kernel A's log against the plain version's: 1e-12.  The
windows here are short (n <= 70), where the sweep's generation chain
amplifies rounding far less than at n=512 (see chip_smoke.py for the
long-window check).  The complex shift kernel: 1e-14 relative to the plain
version's |s|.  The real generalized chase and ladders: 1e-12 on cycles
whose triangular factors have diagonals of modulus in [1, 2).  The
reduction kernel, float64 and complex128: 1e-12 relative to max|A| (n <=
128), similarity residual 2e-13 max|A|, orthonormality 10 eps n.  The
signed reduction's stage 2 (csrc/hess_signed.cu): max(1e-12, 10 x the plain
version's own change under a relative 1e-16 perturbation of A), the chains
amplifying rounding to ~1e-13 at n=20 and ~2e-12 at n=37 (complex; on a
planted exact zero, which the chains turn into rounding noise that later
generations read, O(1): there the similarity contract decides),
similarity residual 1e-12 max|A|.  The deflation actions
(csrc/pqz_deflate.cu): the same gate (chains of generations again), the
plain version's exact zeros (others only where it is at rounding level)
and the same CZSHIFT flag, at even and odd n, with the rotations in shared
memory and (past it) in the global scratch; ``pschur`` at odd n takes all
three actions.  Kernels D and R at the main path's shapes (D at p=16
n=512, R at p=8 n=256) and at p = 1 (D) and 2 (R): 1e-12 (D) and 1e-13
(R) against the plain version, the same exact zeros, and H without Z
identical; launches of either kernel overlapping on two streams give the
results they give alone, bit for bit; past the default shared memory (p =
500 to 2500, where the opt-in and the parent's design run): max(1e-12, 10
x the plain version's sensitivity).  Kernel G: bit for bit with its
plain version and with the numpy host glue (it is written without FMA, in
numpy's order), also at n = 1100 and 3000 (35 and 94 blocks) and with
launches on two streams at once; a call's ``Glue`` keeps its values
across a call on another (p, n).  Kernel S at p = 33 and 40 (more factors than lanes):
1e-14, as above.  AED (``ops/aed.py``, no kernel of its own): the apply on
the card within 1e-13 of the CPU's, with the same exact zeros; the driver at
p=3 n=40 deflates, its eigenvalues within 1e-10 of numpy's, ``check_psd``
at 10 eps n and 40 eps; the signed apply (float64 and complex128, mixed S)
within 1e-13 of the CPU's with the same exact zeros; the rg and cx AED
drivers at n=36 deflate, re-reduce each window with one ``hess_signed``
launch, reconstruct within 1e-11 n max|A| and agree with the CPU's AED-off
core's eigenvalues within 1e-8.  ``ordschur`` and ``eigvecs`` keep a decomposition
on the card, and reorder bit for bit as on the CPU.  ``partial_pschur`` (no
kernel of its own: the operator applications and the Gram-Schmidt are
torch products on the card) on a tensor on the card, and through
matrix-free operators there: outputs on the card, ``nconverged`` as on the
CPU, Ritz values within 1e-10 relative of the CPU run's, the reference's
``check`` contract; one ``CycleOps.apply_orth`` step on the card against
the host ``_orth_step``: 1e-13.  Several problems and shards
(``parallel/``): the shard entries of B0 and B bit for bit the unsharded
launches (1, 2, 4 shards, with and without Z and the want_t=False bounds);
``chase_sweep_sharded`` and ``pschur_real_sharded`` with shards on one card
bit for bit the one-card sweep and run; the ensemble with two workers and
the complex batch bit for bit their one-worker runs; the 33 hostile rg
draws of benchmarks/probe_rg_hostile.py within 120 n iterations and a
backward error of 1e-12.  The two-card tests (the sharded sweep, the ring,
``ShardedCycleOps`` across cuda:0 and cuda:1) skip below two cards.
"""
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.models import krylov
from periodicschurdecompositions_jl_torch.parallel.krylov_ops import CycleOps
from periodicschurdecompositions_jl_torch.ops import (_cuda, deflate, glue, hessenberg,
                                                     pqr_real, pqz_complex, pqz_deflate,
                                                     pqz_real, rgopen, sweep, sweep_cx,
                                                     sweep_rg)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _problem(p, n, seed):
    """Ghost-padded Hessenberg-triangular cycle, orthogonal Z, v0."""
    rng = np.random.default_rng(seed)
    N = n + 1
    H = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
        np.fill_diagonal(H[f, :n, :n], 1.0 + rng.random(n))
    Z = np.zeros((p, N, N))
    for f in range(p):
        Z[f, :n, :n] = np.linalg.qr(rng.standard_normal((n, n)))[0]
    v0 = rng.standard_normal(3)
    return H, Z, v0 / np.abs(v0).sum()


def _structure_exact(H):
    H = H.cpu().numpy()
    assert np.all(np.tril(H[0], -2) == 0)
    for f in range(1, H.shape[0]):
        assert np.all(np.tril(H[f], -1) == 0)


@pytest.mark.parametrize("p,n,m,i,early", [
    (1, 20, 0, 19, False), (2, 20, 3, 17, False), (4, 40, 3, 37, False),
    (3, 12, 4, 6, False), (3, 24, 5, 20, True),
    (1, 70, 2, 66, False),     # p = 1: 64 steps, batches of 30 end mid-batch
    (16, 48, 5, 44, True)])    # p = 16: 39 steps, a 30-step batch then 9
def test_sweep_kernels_match_plain(cuda, p, n, m, i, early):
    Hn, Zn, v0 = _problem(p, n, p * 100 + n)
    if m > 0:
        Hn[0, m, m - 1] = 1e-3 if early else 0.0
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    before = sweep.launches["sweep_generate"]
    Hk, Zk = H0.clone(), Z0.clone()
    sweep.chase_sweep(Hk, Zk, m, i, v0, want_z=True, early=early)
    assert sweep.launches["sweep_generate"] == before + 1
    assert torch.equal(H0, torch.tensor(Hn, device=cuda))
    Hp, Zp = H0.clone(), Z0.clone()
    sweep.chase_sweep_plain(Hp, Zp, m, i, v0, want_z=True, early=early)
    torch.cuda.synchronize()
    scale = float(H0.abs().max())
    assert float((Hk - Hp).abs().max()) <= 1e-12 * scale
    assert float((Zk - Zp).abs().max()) <= 1e-12
    _structure_exact(Hk)
    Hz = H0.clone()
    sweep.chase_sweep(Hz, None, m, i, v0, want_z=False, early=early)
    assert torch.equal(Hz, Hk)
    # kernel A reads H only; its log against the plain version's
    R = sweep.sweep_generate(H0, m, i, v0)
    Rp = torch.zeros_like(R)
    sweep.chase_sweep_plain(H0.clone(), None, m, i, v0, want_z=False, early=early, log=Rp)
    assert torch.equal(H0, torch.tensor(Hn, device=cuda))
    assert float((R[:, m:i] - Rp[:, m:i]).abs().max()) <= 1e-12


def test_sweep_kernel_global_windows(cuda):
    # p = 1500: even one step's windows exceed a block's shared memory, so
    # kernel A keeps them in its global scratch.  5 x 1500 chained
    # generations amplify rounding, so the gate is chip_smoke.py's: 10x the
    # plain version's own change under a relative 1e-16 input perturbation,
    # and at least 1e-12
    p, n, m, i = 1500, 6, 0, 5
    Hn, Zn, v0 = _problem(p, n, 7)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    Hk, Zk = H0.clone(), Z0.clone()
    sweep.chase_sweep(Hk, Zk, m, i, v0, want_z=True)
    Hp, Zp = H0.clone(), Z0.clone()
    sweep.chase_sweep_plain(Hp, Zp, m, i, v0, want_z=True)
    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(Hn.shape),
                        device=cuda)
    Hq, Zq = H0 * pert, Z0.clone()
    sweep.chase_sweep_plain(Hq, Zq, m, i, v0, want_z=True)
    scale = float(H0.abs().max())
    tol_h = max(1e-12, 10 * float((Hq - Hp).abs().max()) / scale)
    tol_z = max(1e-12, 10 * float((Zq - Zp).abs().max()))
    assert float((Hk - Hp).abs().max()) <= tol_h * scale
    assert float((Zk - Zp).abs().max()) <= tol_z
    _structure_exact(Hk)


def _mb_generate(H, m, i, v0, sig, nb, nbact, gap=3):
    """Kernel A-mb straight through its C entry point; returns its log."""
    import ctypes
    p, N, _ = H.shape
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    vals = [float(x) for x in v0] + [float(x) for s3 in sig for x in s3]
    R = torch.empty((nbact, p, N, 9), dtype=torch.float64, device=H.device)
    work = torch.empty(lib.psd_sweep_generate_mb_scratch(p, N, nb, gap), dtype=torch.float64,
                       device=H.device)
    _cuda.check(lib.psd_sweep_generate_mb(H.data_ptr(), work.data_ptr(), R.data_ptr(), p, N,
                                          m, i, nb, gap, nbact,
                                          (ctypes.c_double * len(vals))(*vals), st), "mb")
    return R


@pytest.mark.parametrize("p,n,m,i,nb,nbact,gap", [
    (1, 20, 0, 19, 2, 2, 3), (3, 40, 3, 37, 4, 4, 3), (4, 24, 1, 22, 3, 2, 3),
    (2, 30, 5, 26, 4, 4, 3),
    (2, 41, 3, 40, 3, 3, 5),   # gap 5, odd n
    (3, 25, 2, 8, 4, 4, 3),    # 6 steps, shorter than (nbact-1) gap = 9
    (1, 33, 0, 32, 4, 4, 3),   # p = 1 with four bulges
    (4, 31, 1, 29, 4, 3, 5)])  # gap 5, nbact < nb
def test_mb_sweep_kernels_match_plain(cuda, p, n, m, i, nb, nbact, gap):
    Hn, Zn, v0 = _problem(p, n, p * 100 + n + nb)
    sig = [tuple(0.5 * np.random.default_rng(b).standard_normal(3)) for b in range(nb)]
    if m > 0:
        Hn[0, m, m - 1] = 0.0
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    before = sweep.launches["sweep_generate_mb"]
    Hk, Zk = H0.clone(), Z0.clone()
    sweep.chase_sweep_mb(Hk, Zk, m, i, v0, sig, nbact, nb=nb, gap=gap, want_z=True)
    assert sweep.launches["sweep_generate_mb"] == before + 1
    Hp, Zp = H0.clone(), Z0.clone()
    Rp = torch.zeros((nb, p, n + 1, 9), dtype=torch.float64, device=cuda)
    sweep.chase_sweep_mb_plain(Hp, Zp, m, i, v0, sig, nbact, nb=nb, gap=gap, want_z=True,
                               log=Rp)
    torch.cuda.synchronize()
    scale = float(H0.abs().max())
    assert float((Hk - Hp).abs().max()) <= 1e-12 * scale
    assert float((Zk - Zp).abs().max()) <= 1e-12
    _structure_exact(Hk)
    Hz = H0.clone()
    sweep.chase_sweep_mb(Hz, None, m, i, v0, sig, nbact, nb=nb, gap=gap, want_z=False)
    assert torch.equal(Hz, Hk)
    # A-mb reads H only; its log against the plain version's; B0 + B
    # (bulge-major) on it against apply_log_plain
    R = _mb_generate(H0, m, i, v0, sig, nb, nbact, gap)
    assert torch.equal(H0, torch.tensor(Hn, device=cuda))
    assert float((R - Rp[:nbact])[:, :, m:i].abs().max()) <= 1e-12
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    Hb, Zb = H0.clone(), Z0.clone()
    N = n + 1
    _cuda.check(lib.psd_sweep_left(Hb.data_ptr(), R.data_ptr(), p, N, m, i, nbact, st), "left")
    _cuda.check(lib.psd_sweep_right(Hb.data_ptr(), Zb.data_ptr(), R.data_ptr(), p, N, m, i,
                                    nbact, st), "right")
    Ha, Za = H0.clone(), Z0.clone()
    sweep.apply_log_plain(Ha, Za, R, m, i, want_z=True, nb=nbact)
    torch.cuda.synchronize()
    assert float((Hb - Ha).abs().max()) <= 1e-13 * scale
    assert float((Zb - Za).abs().max()) <= 1e-13
    assert torch.equal(Hb, Hk) and torch.equal(Zb, Zk)


def test_mb_sweep_kernel_global_windows(cuda):
    # p = 150, four bulges at gap 3: even one tick's windows exceed a
    # block's shared memory, so A-mb keeps them in its global scratch.  The
    # chained generations amplify rounding, so the gate is chip_smoke.py's:
    # 10x the plain version's own change under a relative 1e-16 input
    # perturbation, and at least 1e-12
    p, n, m, i, nb = 150, 12, 0, 11, 4
    Hn, Zn, v0 = _problem(p, n, 11)
    sig = [tuple(0.5 * np.random.default_rng(b).standard_normal(3)) for b in range(nb)]
    lib = _cuda.load()
    ring = 1 << ((nb - 1) * 3 + 2).bit_length()  # carried rows per column, a power of two
    assert lib.psd_sweep_generate_mb_scratch(p, n + 1, nb, 3) > ring * p * (n + 1)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    Hk, Zk = H0.clone(), Z0.clone()
    sweep.chase_sweep_mb(Hk, Zk, m, i, v0, sig, nb, nb=nb, gap=3, want_z=True)
    Hp, Zp = H0.clone(), Z0.clone()
    sweep.chase_sweep_mb_plain(Hp, Zp, m, i, v0, sig, nb, nb=nb, gap=3, want_z=True)
    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(Hn.shape),
                        device=cuda)
    Hq, Zq = H0 * pert, Z0.clone()
    sweep.chase_sweep_mb_plain(Hq, Zq, m, i, v0, sig, nb, nb=nb, gap=3, want_z=True)
    scale = float(H0.abs().max())
    tol_h = max(1e-12, 10 * float((Hq - Hp).abs().max()) / scale)
    tol_z = max(1e-12, 10 * float((Zq - Zp).abs().max()))
    assert float((Hk - Hp).abs().max()) <= tol_h * scale
    assert float((Zk - Zp).abs().max()) <= tol_z
    _structure_exact(Hk)


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("p,n,m,i", [(1, 45, 0, 44), (3, 70, 1, 34), (2, 33, 30, 32),
                                     (3, 40, 38, 39)])
def test_apply_kernels_every_nb(cuda, p, n, m, i, nb):
    """B0 + B with nb random orthogonal logs at ragged tiles and spans
    against apply_log_plain (1e-13); B with Z == NULL leaves H as with Z."""
    Hn, Zn, _ = _problem(p, n, p * 10 + n + nb)
    N = n + 1
    q, _ = np.linalg.qr(np.random.default_rng(nb).standard_normal((nb, p, N, 3, 3)))
    R = torch.tensor(q.reshape(nb, p, N, 9), device=cuda)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    Hb, Zb, Hz = H0.clone(), Z0.clone(), H0.clone()
    for Hx, Zx in ((Hb, Zb), (Hz, None)):
        _cuda.check(lib.psd_sweep_left(Hx.data_ptr(), R.data_ptr(), p, N, m, i, nb, st), "left")
        _cuda.check(lib.psd_sweep_right(Hx.data_ptr(), None if Zx is None else Zx.data_ptr(),
                                        R.data_ptr(), p, N, m, i, nb, st), "right")
    Ha, Za = H0.clone(), Z0.clone()
    sweep.apply_log_plain(Ha, Za, R, m, i, want_z=True, nb=nb)
    torch.cuda.synchronize()
    assert float((Hb - Ha).abs().max()) <= 1e-13 * float(H0.abs().max())
    assert float((Zb - Za).abs().max()) <= 1e-13
    assert torch.equal(Hz, Hb)


@pytest.mark.parametrize("p,n,m,i", [(1, 20, 0, 19), (3, 24, 5, 20)])
def test_mb_kernels_with_one_bulge_are_the_single_sweep(cuda, p, n, m, i):
    Hn, Zn, v0 = _problem(p, n, p * 100 + n)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    H1, Z1 = H0.clone(), Z0.clone()
    sweep.chase_sweep(H1, Z1, m, i, v0, want_z=True)
    H2, Z2 = H0.clone(), Z0.clone()
    sweep.chase_sweep_mb(H2, Z2, m, i, v0, [(0.0, 0.0, 0.0)], 1, nb=1, gap=3, want_z=True)
    torch.cuda.synchronize()
    assert torch.equal(H1, H2) and torch.equal(Z1, Z2)


def test_mb_pipeline_on_the_card(cuda):
    p, n = 4, 64
    A = np.random.default_rng(p + n).standard_normal((p, n, n))
    for k in sweep.launches:
        sweep.launches[k] = 0
    cfg = AlgoConfig(nbulges=4)
    P = pqr_real.pschur_real_pipeline(torch.tensor(A, device=cuda), "R", cfg=cfg)
    info = dict(pqr_real.last_info)
    assert sweep.launches["sweep_generate_mb"] == info["sweeps"] > 0
    assert sweep.launches["sweep_generate"] == 0 and info["bulges"] > info["sweeps"]
    ok, rep = pt.check_psd(P, A)  # n=64: one bulge also needs ~50 eps of the residual
    assert ok, rep
    Pc = pqr_real.pschur_real_pipeline(torch.tensor(A), "R", cfg=cfg)
    w = np.sort_complex(P.values.cpu().numpy())
    wc = np.sort_complex(Pc.values.numpy())
    assert np.abs(w - wc).max() <= 1e-10 * np.abs(wc).max()


@pytest.mark.parametrize("case", ["chainA", "chainB", "chainB-jmax"])
def test_deflate_kernel_matches_plain(cuda, case):
    p, n, i = 5, 30, 17
    Hn, Zn, _ = _problem(p, n, 7)
    Hn[0, i + 1, i] = 0.0
    if case == "chainA":
        Hn[4, i - 1, i - 1] = 1e-30
    elif case == "chainB-jmax":
        Hn[2, i, i] = 1e-30
    ulp = float(np.finfo(np.float64).eps)
    smlnum = float(np.finfo(np.float64).tiny) * (n / ulp)
    hnorms = ulp * n * np.abs(Hn[:, :n, :n]).sum(axis=1).max(axis=1)
    D = np.stack([np.diagonal(Hn[f])[:n] for f in range(p)])
    U = np.stack([np.concatenate([np.diagonal(Hn[f], 1)[:n - 1], [0.0]])
                  for f in range(p)])
    S0 = np.concatenate([[0.0], np.diagonal(Hn[0], -1)[:n - 1]])
    sc = pqr_real.defl2_scalars(D, U, S0, i, p, hnorms, ulp, smlnum)
    assert (sc["jmin"] >= 1) == (case == "chainA")
    args = (i, sc["jmin"], sc["jmax"], sc["cs0"], sc["sn0"], sc["replace0"],
            sc["finzero"], sc["thr"])
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    Hk, Zk = H0.clone(), Z0.clone()
    deflate.deflate2x2(Hk, Zk, *args, want_z=True)
    Hp, Zp = H0.clone(), Z0.clone()
    deflate.deflate2x2_plain(Hp, Zp, *args, want_z=True)
    torch.cuda.synchronize()
    assert float((Hk - Hp).abs().max()) <= 1e-12 * float(H0.abs().max())
    assert float((Zk - Zp).abs().max()) <= 1e-12
    Hz = H0.clone()
    deflate.deflate2x2(Hz, None, *args, want_z=False)
    assert torch.equal(Hz, Hk)


def _deflate_args(Hn, i, replace=None):
    from chip_smoke import deflate_scalars
    sc = deflate_scalars(Hn, i)
    rep = sc["replace0"] if replace is None else replace
    return (i, sc["jmin"], sc["jmax"], sc["cs0"], sc["sn0"], rep, sc["finzero"], sc["thr"])


def _ladder_agrees(H0, Z0, run, plain, tol=1e-12):
    """The kernel (run) against the plain version on copies: within tol of
    max|H| (tol on Z), the same exact zeros, and without Z the same H."""
    Hk, Zk = H0.clone(), Z0.clone()
    run(Hk, Zk)
    Hp, Zp = H0.clone(), Z0.clone()
    plain(Hp, Zp)
    Hz = H0.clone()
    run(Hz, None)
    torch.cuda.synchronize()
    assert float((Hk - Hp).abs().max()) <= tol * float(H0.abs().max())
    assert float((Zk - Zp).abs().max()) <= tol
    assert torch.equal(Hk == 0, Hp == 0)
    assert torch.equal(Hz, Hk)


@pytest.mark.parametrize("case", ["chainA", "chainB", "chainB-jmax", "rounds"])
def test_deflate_kernel_at_the_headline_shape(cuda, case):
    """Kernel D at p=16 n=512 i=300 on chip_smoke.py's deflate_cases, and on
    chainB replacing from the first round (a loop of several rounds)."""
    from chip_smoke import deflate_cases
    cases = {c[0]: c[1:] for c in deflate_cases(16, 512)}
    Hn, Zn, i = cases["chainB" if case == "rounds" else case]
    args = _deflate_args(Hn, i, True if case == "rounds" else None)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    _ladder_agrees(H0, Z0, lambda H, Z: deflate.deflate2x2(H, Z, *args, want_z=Z is not None),
                   lambda H, Z: deflate.deflate2x2_plain(H, Z, *args, want_z=True))


@pytest.mark.parametrize("i", [1, 6, 10])
def test_deflate_kernel_with_one_factor(cuda, i):
    """p = 1: the rotation's rows and columns land on the one factor."""
    Hn, Zn, _ = _problem(1, 12, 3 + i)
    if i + 1 < 12:
        Hn[0, i + 1, i] = 0.0
    for rep in (False, True):
        args = _deflate_args(Hn, i, rep)
        H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
        _ladder_agrees(H0, Z0,
                       lambda H, Z: deflate.deflate2x2(H, Z, *args, want_z=Z is not None),
                       lambda H, Z: deflate.deflate2x2_plain(H, Z, *args, want_z=True))


RG_SPOTS = [("open", 0, 255), ("open", 37, 200), ("close", 254, 255), ("close", 199, 200),
            ("chain", 100, 101), ("chain", 254, 255)]


@pytest.mark.parametrize("mode,j,il", RG_SPOTS)
def test_rg_ladder_kernel_at_the_rg_shape(cuda, mode, j, il):
    """Kernel R at p=8 n=256 on chip_smoke.py's six spots, alternating S,
    with and without want_t=False bounds."""
    from chip_smoke import alternating, mk_rg_problem
    Hn, Zn, rotn = mk_rg_problem(8, 256, np.random.default_rng(2026))
    S = alternating(8)
    rot = torch.tensor(rotn, device=cuda)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    for bd in ({}, {"rhi": il + 1, "clo": max(j - 5, 0)}):
        _ladder_agrees(
            H0, Z0,
            lambda H, Z: rgopen.rg_ladder(H, Z, mode, j, il, rot, S, want_z=Z is not None, **bd),
            lambda H, Z: rgopen.rg_ladder_plain(H, Z, mode, j, il, rot, S, want_z=True, **bd),
            tol=1e-13)


@pytest.mark.parametrize("mode", ["open", "close", "chain"])
def test_rg_ladder_kernel_with_two_factors(cuda, mode):
    Hn, Zn, rotn = _rg_problem(2, 11, 4)
    j = {"open": 0, "close": 9, "chain": 4}[mode]
    Hn[0, j + 2 if j + 2 < 11 else j + 1, max(j - 1, 0)] = 0.25
    rot = torch.tensor(rotn, device=cuda)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    for S in ((True, False), (True, True)):
        for bd in ({}, {"rhi": j + 2, "clo": j + 1}):
            _ladder_agrees(
                H0, Z0,
                lambda H, Z: rgopen.rg_ladder(H, Z, mode, j, 10, rot, S, want_z=Z is not None,
                                              **bd),
                lambda H, Z: rgopen.rg_ladder_plain(H, Z, mode, j, 10, rot, S, want_z=True,
                                                    **bd), tol=1e-13)


@pytest.mark.parametrize("kernel", ["D", "R"])
def test_ladders_on_two_streams_at_once(cuda, kernel):
    """Two problems at the main path's shapes, the second without Z (so the
    two grids differ), each taking the kernel 64 times in place on its own
    stream, queued behind a ~10 ms spin on both streams so that the two
    streams' launches run at once: each result is bit for bit the one its
    launches give alone; alone, the first 8 are within 1e-12 of the plain
    version's 8 (1e-12 on Z)."""
    if kernel == "D":
        from chip_smoke import deflate_cases
        cases = {c[0]: c[1:] for c in deflate_cases(16, 512)}
        probs = []
        for name in ("chainB", "chainA"):
            Hn, Zn, i = cases[name]
            args = _deflate_args(Hn, i)
            probs.append((Hn, Zn, (
                lambda H, Z, a=args: deflate.deflate2x2(H, Z, *a, want_z=Z is not None),
                lambda H, Z, a=args: deflate.deflate2x2_plain(H, Z, *a,
                                                               want_z=Z is not None))))
    else:
        from chip_smoke import alternating, mk_rg_problem
        Hn, Zn, rotn = mk_rg_problem(8, 256, np.random.default_rng(2026))
        S, rot = alternating(8), torch.tensor(rotn, device=cuda)
        probs = [(Hn, Zn, tuple(
            lambda H, Z, f=f, m=mode, j=j, il=il: f(H, Z, m, j, il, rot, S,
                                                    want_z=Z is not None)
            for f in (rgopen.rg_ladder, rgopen.rg_ladder_plain)))
            for mode, j, il in (("open", 0, 255), ("chain", 100, 101))]

    def fresh(Hn, Zn, k):
        return torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda) if k == 0 else None

    alone, both = [], []
    for k, (Hn, Zn, (run, ref)) in enumerate(probs):
        H, Z = fresh(Hn, Zn, k)
        Hp, Zp = fresh(Hn, Zn, k)
        for t in range(64):
            run(H, Z)
            if t < 8:
                ref(Hp, Zp)
            if t == 7:
                torch.cuda.synchronize()
                assert float((H - Hp).abs().max()) <= 1e-12 * float(np.abs(Hn).max())
                assert Z is None or float((Z - Zp).abs().max()) <= 1e-12
        alone.append((H, Z))
        both.append(fresh(Hn, Zn, k))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
    for _ in range(64):
        for s, (H, Z), (_, _, (run, _)) in zip(streams, both, probs):
            with torch.cuda.stream(s):
                run(H, Z)
    torch.cuda.synchronize()
    for (Ha, Za), (Hb, Zb) in zip(alone, both):
        assert torch.equal(Hb, Ha) and (Za is None or torch.equal(Zb, Za))


@pytest.mark.parametrize("kernel,p", [("D", 600), ("D", 2500), ("R", 500), ("R", 2300)])
def test_ladders_past_the_default_shared_memory(cuda, kernel, p):
    """Long cycles: the windows past 48 KB of shared memory (the opt-in) and
    past a block's opt-in (the parent's design), against the plain version
    within max(1e-12, 10 x its own change under a relative 1e-16
    perturbation): a chain of p generations amplifies rounding."""
    if kernel == "D":
        Hn, Zn, _ = _problem(p, 6, p)
        Hn[0, 4, 3] = 0.0
        c, s = np.random.default_rng(p).standard_normal(2)
        args = (3, -1, -1, c / np.hypot(c, s), s / np.hypot(c, s), False, False, 0.0)

        def plain(H, Z):
            deflate.deflate2x2_plain(H, Z, *args, want_z=True)

        def run(H, Z):
            deflate.deflate2x2(H, Z, *args, want_z=Z is not None)
    else:
        Hn, Zn, rotn = _rg_problem(p, 6, p)
        S = tuple(l % 3 != 1 for l in range(p))
        rot = torch.tensor(rotn, device=cuda)

        def plain(H, Z):
            rgopen.rg_ladder_plain(H, Z, "open", 1, 5, rot, S, want_z=True)

        def run(H, Z):
            rgopen.rg_ladder(H, Z, "open", 1, 5, rot, S, want_z=Z is not None)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    Hp, Zp = H0.clone(), Z0.clone()
    plain(Hp, Zp)
    Hq = H0 * torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(Hn.shape),
                           device=cuda)
    Zq = Z0.clone()
    plain(Hq, Zq)
    sens = max(float((Hq - Hp).abs().max()) / float(H0.abs().max()),
               float((Zq - Zp).abs().max()))
    _ladder_agrees(H0, Z0, run, plain, tol=max(1e-12, 10 * sens))


@pytest.mark.parametrize("p,n,lr", [(1, 30, "R"), (3, 40, "R"), (4, 24, "L")])
def test_pschur_on_the_card(cuda, p, n, lr):
    A = np.random.default_rng(p + n).standard_normal((p, n, n))
    for d in (sweep.launches, deflate.launches):
        for k in d:
            d[k] = 0
    P = pt.pschur(torch.tensor(A, device=cuda), lr)
    assert sweep.launches["sweep_generate"] > 0 and deflate.launches["deflate2x2"] > 0
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep
    Pc = pt.pschur(torch.tensor(A), lr)
    w = np.sort_complex(P.values.cpu().numpy())
    wc = np.sort_complex(Pc.values.numpy())
    assert np.abs(w - wc).max() <= 1e-10 * np.abs(wc).max()


@pytest.mark.parametrize("cfg", [AlgoConfig(allow_early_qr=True),
                                 AlgoConfig(extra_rq=True)])
def test_core_switches_on_the_card(cuda, cfg):
    p, n = 3, 24
    rng = np.random.default_rng(5)
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f] = np.triu(rng.standard_normal((n, n)))
    H[1][6, 6] = 1e-30   # the repair chain runs
    out_k = pqr_real.pqr_real_core(torch.tensor(H, device=cuda), cfg=cfg)
    out_c = pqr_real.pqr_real_core(torch.tensor(H), cfg=cfg)
    assert out_k[4] and out_c[4]
    wk = np.sort_complex(out_k[2] + 1j * out_k[3])
    wc = np.sort_complex(out_c[2] + 1j * out_c[3])
    assert np.abs(wk - wc).max() <= 1e-10 * np.abs(wc).max()


def _cx_problem(p, n, seed):
    """Complex Hessenberg-triangular cycle (triangular diagonals of modulus
    in [1, 2)), unitary Z, and a shift rotation (c, s)."""
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    H = np.zeros((p, n, n), complex)
    H[0] = np.triu(cplx(n, n), -1)
    for f in range(1, p):
        H[f] = np.triu(cplx(n, n))
        d = cplx(n)
        np.fill_diagonal(H[f], d / np.abs(d) * (1.0 + rng.random(n)))
    Z = np.stack([np.linalg.qr(cplx(n, n))[0] for _ in range(p)])
    f, g = cplx(2)
    d = np.hypot(abs(f), abs(g))
    return H, Z, np.array([abs(f) / d, (f / abs(f)) * np.conj(g) / d])


@pytest.mark.parametrize("p,n,S,m,i", [
    (1, 20, (True,), 0, 19), (2, 20, (True, False), 3, 17),
    (4, 40, (True, False, True, False), 0, 39), (3, 12, (True, True, False), 4, 6),
    (3, 24, (True, True, True), 5, 20),
    (1, 70, (True,), 2, 66),                    # p = 1: 64 steps, batches of 30
    (8, 48, (True,) + (False,) * 7, 5, 44),     # S all False but S[0]: 30 + 9 steps
    # B0/B's 16-position chunks and 32-line tiles: p = 1 across both edges;
    # a window across one chunk edge; odd n with a one-line last tile and a
    # ragged last chunk; one step at a tile edge
    (1, 100, (True,), 15, 80), (2, 70, (True, False), 3, 20),
    (3, 65, (True, True, False), 0, 64), (2, 34, (True, False), 32, 33)])
def test_cx_sweep_kernels_match_plain(cuda, p, n, S, m, i):
    Hn, Zn, cs = _cx_problem(p, n, p * 100 + n)
    if i + 1 < n:
        Hn[0, i + 1, i] = 0.0
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    cst = torch.tensor(cs, device=cuda)
    before = sweep_cx.launches["qz_sweep_generate"]
    Hk, Zk = H0.clone(), Z0.clone()
    sweep_cx.qz_sweep(Hk, Zk, m, i, cst, S, want_z=True)
    assert sweep_cx.launches["qz_sweep_generate"] == before + 1
    Hp, Zp = H0.clone(), Z0.clone()
    sweep_cx.qz_sweep_plain(Hp, Zp, m, i, cst, S, want_z=True)
    torch.cuda.synchronize()
    scale = float(H0.abs().max())
    assert float((Hk - Hp).abs().max()) <= 1e-12 * scale
    assert float((Zk - Zp).abs().max()) <= 1e-12
    _structure_exact(Hk)
    assert torch.equal(Hk[0, :, :m], H0[0, :, :m])   # boundary column kept
    Hz = H0.clone()
    sweep_cx.qz_sweep(Hz, None, m, i, cst, S, want_z=False)
    assert torch.equal(Hz, Hk)
    # kernel A reads H only; its log against the plain version's
    log = sweep_cx.qz_sweep_generate(H0, m, i, cst, S)
    assert torch.equal(H0, torch.tensor(Hn, device=cuda))
    logp = torch.zeros_like(log)
    sweep_cx.qz_sweep_plain(H0.clone(), None, m, i, cst, S, want_z=False, log=logp)
    assert float((log[:, m:i, :12] - logp[:, m:i, :12]).abs().max()) <= 1e-12
    assert float((log[0, m:i, 12] - logp[0, m:i, 12]).abs().max()) <= 1e-12 * scale
    # B0 and B alone on that log, with and without Z: against
    # qz_apply_log_plain, the logged subdiagonal written exactly
    lib, st = _cuda.load(), torch.cuda.current_stream().cuda_stream
    Ha, Za = H0.clone(), Z0.clone()
    sweep_cx.qz_apply_log_plain(Ha, Za, log, m, i, want_z=True)
    for want_z in (True, False):
        Hb, Zb = H0.clone(), Z0.clone()
        _cuda.check(lib.psd_qz_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, st),
                    "qz_sweep_left")
        _cuda.check(lib.psd_qz_sweep_right(Hb.data_ptr(), Zb.data_ptr() if want_z else None,
                                           log.data_ptr(), p, n, m, i, st), "qz_sweep_right")
        torch.cuda.synchronize()
        assert float((Hb - Ha).abs().max()) <= 1e-13 * scale
        if want_z:
            assert float((Zb - Za).abs().max()) <= 1e-13
        else:
            assert torch.equal(Zb, Z0)
        _structure_exact(Hb)
        assert torch.equal(Hb[0, :, :m], H0[0, :, :m])
        r = torch.arange(m + 1, i, device=cuda)
        assert torch.equal(Hb[0, r, r - 1], log[0, m + 1:i, 12])


def test_cx_sweep_kernel_global_windows(cuda):
    # p = 1500: even one step's windows exceed a block's shared memory, so
    # the complex kernel A keeps them in its global scratch.  5 x 1500
    # chained generations amplify rounding, so the gate is chip_smoke.py's:
    # 10x the plain version's own change under a relative 1e-16 input
    # perturbation, and at least 1e-12
    p, n, m, i = 1500, 6, 0, 5
    S = tuple(l % 2 == 0 for l in range(p))
    Hn, Zn, cs = _cx_problem(p, n, 7)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    cst = torch.tensor(cs, device=cuda)
    Hk, Zk = H0.clone(), Z0.clone()
    sweep_cx.qz_sweep(Hk, Zk, m, i, cst, S, want_z=True)
    Hp, Zp = H0.clone(), Z0.clone()
    sweep_cx.qz_sweep_plain(Hp, Zp, m, i, cst, S, want_z=True)
    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(Hn.shape),
                        device=cuda)
    Hq, Zq = H0 * pert, Z0.clone()
    sweep_cx.qz_sweep_plain(Hq, Zq, m, i, cst, S, want_z=True)
    scale = float(H0.abs().max())
    tol_h = max(1e-12, 10 * float((Hq - Hp).abs().max()) / scale)
    tol_z = max(1e-12, 10 * float((Zq - Zp).abs().max()))
    assert float((Hk - Hp).abs().max()) <= tol_h * scale
    assert float((Zk - Zp).abs().max()) <= tol_z
    _structure_exact(Hk)


@pytest.mark.parametrize("S", [(True, True, True, True), (True, False, True, False)])
def test_cx_shift_kernel_matches_plain(cuda, S):
    Hn, _, _ = _cx_problem(len(S), 16, 11)
    H = torch.tensor(Hn, device=cuda)
    for (a, b) in [(0, 15), (3, 9), (7, 8)]:
        ck = sweep_cx.qz_shift(H, a, b, S)
        cp = sweep_cx.qz_shift_plain(H, a, b, S)
        assert float((ck - cp).abs().max()) <= 1e-14


@pytest.mark.parametrize("p,n,S,lr", [(3, 24, None, "R"), (4, 20, (True, False, True, False), "R"),
                                      (3, 16, (False, True, True), "L")])
def test_pschur_complex_on_the_card(cuda, p, n, S, lr):
    rng = np.random.default_rng(p + n)
    A = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    for k in sweep_cx.launches:
        sweep_cx.launches[k] = 0
    P = pt.pschur(torch.tensor(A, device=cuda), lr, S=S)
    assert all(v > 0 for v in sweep_cx.launches.values()), sweep_cx.launches
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep
    Pc = pt.pschur(torch.tensor(A), lr, S=S)
    w = np.sort_complex(P.values.cpu().numpy())
    wc = np.sort_complex(Pc.values.numpy())
    assert np.abs(w - wc).max() <= 1e-10 * np.abs(wc).max()
    assert pqz_complex.last_info["converged"]


def _rg_problem(p, n, seed):
    """Real Hessenberg-triangular cycle (triangular diagonals of modulus in
    [1, 2)), orthogonal Z and opening rotations (c1, s1, c2, s2)."""
    rng = np.random.default_rng(seed)
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f] = np.triu(rng.standard_normal((n, n)))
        d = rng.standard_normal(n)
        np.fill_diagonal(H[f], np.where(d >= 0, 1.0, -1.0) * (1.0 + rng.random(n)))
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(p)])
    a, b = rng.standard_normal(2), rng.standard_normal(2)
    rot = np.array([abs(a[0]), np.sign(a[0]) * a[1], abs(b[0]), np.sign(b[0]) * b[1]])
    rot[:2] /= np.hypot(*a)
    rot[2:] /= np.hypot(*b)
    return H, Z, rot


@pytest.mark.parametrize("p,n,S,m,i", [
    (2, 20, (True, False), 1, 19), (3, 24, (True, True, False), 4, 20),
    (4, 40, (True, False, True, False), 1, 39), (3, 12, (True, False, True), 5, 8),
    (2, 70, (True, True), 1, 69),                # p = 2: 67 steps, batches of 29
    (3, 70, (True, False, True), 2, 66),
    (8, 48, (True,) + (False,) * 7, 5, 44),     # S all False but S[0]: 29 + 9 steps
    # rg B0/B's tiles of 16 lines and chunks of 32 / 24 positions: odd n
    # (rows not 16-byte aligned) with ragged tiles and chunks; one step at
    # the matrix's end; one step inside, across a tile edge
    (3, 129, (True, False, True), 1, 128), (2, 33, (True, False), 30, 32),
    (4, 45, (True, False, True, False), 15, 17)])
def test_rg_chase_kernels_match_plain(cuda, p, n, S, m, i):
    Hn, Zn, rot = _rg_problem(p, n, p * 100 + n)
    if m > 1:
        Hn[0, m - 1, m - 2] = 0.0
    if i + 1 < n:
        Hn[0, i + 1, i] = 0.0
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    # the opening leaves the bulge the chase starts from
    rgopen.rg_ladder_plain(H0, Z0, "open", m - 1, i, torch.tensor(rot, device=cuda), S,
                           want_z=True)
    before = sweep_rg.launches["rg_sweep_generate"]
    Hk, Zk = H0.clone(), Z0.clone()
    sweep_rg.rg_chase(Hk, Zk, m, i, S, want_z=True)
    assert sweep_rg.launches["rg_sweep_generate"] == before + 1
    Hp, Zp = H0.clone(), Z0.clone()
    log = torch.zeros((p, n, sweep_rg.LOG), dtype=torch.float64, device=cuda)
    sweep_rg.rg_chase_plain(Hp, Zp, m, i, S, want_z=True, log=log)
    torch.cuda.synchronize()
    scale = float(H0.abs().max())
    assert float((Hk - Hp).abs().max()) <= 1e-12 * scale
    assert float((Zk - Zp).abs().max()) <= 1e-12
    Hs = Hk.clone()
    assert float(Hs[0, i, i - 2].abs()) > 0       # the closing bulge is kept
    Hs[0, i, i - 2] = 0.0
    _structure_exact(Hs)
    assert torch.equal(Hk[0, :, :m - 1], H0[0, :, :m - 1])
    Hz = H0.clone()
    sweep_rg.rg_chase(Hz, None, m, i, S, want_z=False)
    assert torch.equal(Hz, Hk)
    # kernel rg A reads H only; its log against the plain version's
    H0c = H0.clone()
    logk = sweep_rg.rg_sweep_generate(H0, m, i, S)
    assert torch.equal(H0, H0c)
    assert float((logk[:, m:i - 1, :27] - log[:, m:i - 1, :27]).abs().max()) <= 1e-12
    assert float((logk[0, m:i - 1, 27] - log[0, m:i - 1, 27]).abs().max()) <= 1e-12 * scale
    # B0 + B on the plain log against their plain version
    lib = _cuda.load()
    Hb, Zb = H0.clone(), Z0.clone()
    st = torch.cuda.current_stream().cuda_stream
    _cuda.check(lib.psd_rg_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, st), "left")
    _cuda.check(lib.psd_rg_sweep_right(Hb.data_ptr(), Zb.data_ptr(), log.data_ptr(), p, n,
                                       m, i, st), "right")
    Ha, Za = H0.clone(), Z0.clone()
    sweep_rg.rg_apply_log_plain(Ha, Za, log, m, i, want_z=True)
    torch.cuda.synchronize()
    assert float((Hb - Ha).abs().max()) <= 1e-13 * scale
    assert float((Zb - Za).abs().max()) <= 1e-13
    # without Z: the same H, Z untouched; the regenerated r exact
    Hn_, Zn_ = H0.clone(), Z0.clone()
    _cuda.check(lib.psd_rg_sweep_left(Hn_.data_ptr(), log.data_ptr(), p, n, m, i, st), "left")
    _cuda.check(lib.psd_rg_sweep_right(Hn_.data_ptr(), None, log.data_ptr(), p, n, m, i, st),
                "right")
    torch.cuda.synchronize()
    assert torch.equal(Hn_, Hb) and torch.equal(Zn_, Z0)
    r = torch.arange(m, i - 1, device=cuda)
    assert torch.equal(Hb[0, r, r - 1], log[0, m:i - 1, 27])


def test_rg_chase_kernel_global_windows(cuda):
    # p = 1500: even one step's windows exceed a block's shared memory, so
    # kernel rg A keeps them in its global scratch.  5 x 1500 chained pairs
    # of generations amplify rounding, so the gate is chip_smoke.py's: 10x
    # the plain version's own change under a relative 1e-16 input
    # perturbation, and at least 1e-12
    p, n, m, i = 1500, 8, 1, 7
    S = tuple(l % 2 == 0 for l in range(p))
    Hn, Zn, rot = _rg_problem(p, n, 7)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    rgopen.rg_ladder_plain(H0, Z0, "open", m - 1, i, torch.tensor(rot, device=cuda), S,
                           want_z=True)
    Hk, Zk = H0.clone(), Z0.clone()
    sweep_rg.rg_chase(Hk, Zk, m, i, S, want_z=True)
    Hp, Zp = H0.clone(), Z0.clone()
    sweep_rg.rg_chase_plain(Hp, Zp, m, i, S, want_z=True)
    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(Hn.shape),
                        device=cuda)
    Hq, Zq = H0 * pert, Z0.clone()
    sweep_rg.rg_chase_plain(Hq, Zq, m, i, S, want_z=True)
    scale = float(H0.abs().max())
    tol_h = max(1e-12, 10 * float((Hq - Hp).abs().max()) / scale)
    tol_z = max(1e-12, 10 * float((Zq - Zp).abs().max()))
    assert float((Hk - Hp).abs().max()) <= tol_h * scale
    assert float((Zk - Zp).abs().max()) <= tol_z
    Hs = Hk.clone()
    Hs[0, i, i - 2] = 0.0
    _structure_exact(Hs)


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return (torch.device("cuda:0"), torch.device("cuda:1"))


def test_sharded_sweep_across_two_cards():
    mesh = _two_cards()
    p, n, m, i = 3, 63, 2, 61
    Hn, Zn, v0 = _problem(p, n, 41)
    H0, Z0 = torch.tensor(Hn, device=mesh[0]), torch.tensor(Zn, device=mesh[0])
    H0[0, m, m - 1] = 0.0
    Hu, Zu = H0.clone(), Z0.clone()
    sweep.chase_sweep(Hu, Zu, m, i, v0, want_z=True)
    Hs, Zs = H0.clone(), Z0.clone()
    pt.chase_sweep_sharded(Hs, Zs, m, i, v0, devices=mesh * 2, want_z=True)
    torch.cuda.synchronize(mesh[1])
    assert torch.equal(Hs, Hu) and torch.equal(Zs, Zu)
    T, Z, w, ok = pt.pschur_real_sharded(torch.tensor(np.random.default_rng(3).standard_normal(
        (3, 31, 31)), device=mesh[0]), mesh)
    P = pqr_real.pschur_real_pipeline(torch.tensor(np.random.default_rng(3).standard_normal(
        (3, 31, 31)), device=mesh[0]), "R", cfg=AlgoConfig(aed=False, host_tail=-1))
    assert ok and torch.equal(T, P.Ts) and torch.equal(Z, P.Zs)


def test_ring_and_sharded_krylov_across_two_cards():
    mesh = _two_cards()
    rng = np.random.default_rng(42)
    p, n = 4, 64
    A = torch.tensor(rng.standard_normal((p, n, n)) / np.sqrt(n), device=mesh[0])
    V = torch.tensor(rng.standard_normal((2, n, 3)), device=mesh[0])
    out = pt.ring_cycle_products(A, V, mesh)
    for d in range(2):
        x = V[d]
        for k in [(2 * d + j) % p for j in range(p)]:
            x = A[k] @ x
        assert float((out[d] - x).abs().max()) <= 1e-12 * float(x.abs().max())
    v = V[0, :, 0]
    x = v
    for k in range(p):
        x = A[k] @ x
    y = pt.ring_product_apply(A, v, mesh)
    assert y.device == mesh[0] and float((y - x).abs().max()) <= 1e-12 * float(x.abs().max())
    Ak = torch.tensor(np.stack([np.diag(1.2 ** np.arange(n)) + 0.01 * rng.standard_normal((n, n))
                                for _ in range(2)]), device=mesh[0])
    ps1, h1 = pt.partial_pschur(Ak, 3, "LM", seed=2)
    ps2, h2 = pt.partial_pschur(pt.ShardedCycleOps(Ak, mesh), 3, "LM", seed=2)
    a = np.sort_complex(ps2.values.cpu().numpy())
    b = np.sort_complex(ps1.values.cpu().numpy())
    assert h2.nconverged == h1.nconverged and np.abs(a - b).max() <= 1e-10 * np.abs(b).max()


def test_launches_go_to_the_tensors_card():
    # the C entry points size and launch on the current device: the
    # wrappers make the tensor's card current around each launch
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda:1")
    p, n, m, i = 4, 40, 1, 39
    S = (True, False, True, False)
    Hn, Zn, rot = _rg_problem(p, n, 11)
    H0, Z0 = torch.tensor(Hn, device=dev), torch.tensor(Zn, device=dev)
    rgopen.rg_ladder_plain(H0, Z0, "open", m - 1, i, torch.tensor(rot, device=dev), S,
                           want_z=True)
    A = torch.tensor(np.random.default_rng(12).standard_normal((3, 48, 48)), device=dev)
    with torch.cuda.device(0):
        Hk, Zk = H0.clone(), Z0.clone()
        sweep_rg.rg_chase(Hk, Zk, m, i, S, want_z=True)
        H, Q = hessenberg.phessenberg_core(A)
    Hp, Zp = H0.clone(), Z0.clone()
    sweep_rg.rg_chase_plain(Hp, Zp, m, i, S, want_z=True)
    Hr, Qr = hessenberg.phessenberg_core_plain(A)
    torch.cuda.synchronize(dev)
    assert Hk.device == dev and H.device == dev
    assert float((Hk - Hp).abs().max()) <= 1e-12 * float(H0.abs().max())
    assert float((Zk - Zp).abs().max()) <= 1e-12
    assert float((H - Hr).abs().max()) <= 1e-12 * float(A.abs().max())
    assert float((Q - Qr).abs().max()) <= 1e-12


@pytest.mark.parametrize("mode", ["open", "close", "chain"])
@pytest.mark.parametrize("S", [(True, False, True, False), (True, True, False)])
def test_rg_ladder_kernel_matches_plain(cuda, mode, S):
    p, n = len(S), 16
    Hn, Zn, rot = _rg_problem(p, n, 3 * p + len(mode))
    j = {"open": 4, "close": 11, "chain": 7}[mode]
    Hn[0, j + 2, j] = 0.5           # the closing bulge the close mode consumes
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    rt = torch.tensor(rot, device=cuda)
    for bounds in ({}, {"rhi": 13, "clo": 2}):
        Hk, Zk = H0.clone(), Z0.clone()
        rgopen.rg_ladder(Hk, Zk, mode, j, 12, rt, S, want_z=True, **bounds)
        Hp, Zp = H0.clone(), Z0.clone()
        rgopen.rg_ladder_plain(Hp, Zp, mode, j, 12, rt, S, want_z=True, **bounds)
        torch.cuda.synchronize()
        assert float((Hk - Hp).abs().max()) <= 1e-13 * float(H0.abs().max())
        assert float((Zk - Zp).abs().max()) <= 1e-13
        Hz = H0.clone()
        rgopen.rg_ladder(Hz, None, mode, j, 12, rt, S, want_z=False, **bounds)
        assert torch.equal(Hz, Hk)


@pytest.mark.parametrize("p,n,S,lr", [(4, 24, (True, False, True, False), "R"),
                                      (3, 20, (False, True, True), "L"),
                                      (3, 16, (True, True, True), "R")])
def test_pschur_real_gen_on_the_card(cuda, p, n, S, lr):
    A = np.random.default_rng(p + n).standard_normal((p, n, n))
    counters = (sweep_rg.launches, rgopen.launches)
    for d in counters:
        for k in d:
            d[k] = 0
    P = pt.pschur(torch.tensor(A, device=cuda), lr, S=S)
    assert all(v > 0 for d in counters for v in d.values()), counters
    ok, rep = pt.check_psd(P, A, tol=32.0)
    assert ok, rep
    Pc = pt.pschur(torch.tensor(A), lr, S=S)
    w = np.sort_complex(P.values.cpu().numpy())
    wc = np.sort_complex(Pc.values.numpy())
    assert np.abs(w - wc).max() <= 1e-10 * np.abs(wc).max()
    assert pqz_real.last_info["converged"]


@pytest.mark.parametrize("p,n", [(1, 33), (4, 64), (16, 128)])
def test_hess_kernel_matches_plain(cuda, p, n):
    A = torch.tensor(np.random.default_rng(1000 * p + n).standard_normal((p, n, n)),
                     device=cuda)
    before = hessenberg.launches["hess_reduce"]
    H, Q = hessenberg.phessenberg_core(A)
    assert hessenberg.launches["hess_reduce"] - before == 1  # one cooperative launch
    Hp, Qp = hessenberg.phessenberg_core_plain(A)
    torch.cuda.synchronize()
    scale = float(A.abs().max())
    assert float((H - Hp).abs().max()) <= 1e-12 * scale
    assert float((Q - Qp).abs().max()) <= 1e-12
    _structure_exact(H)
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    for l in range(p):
        R = Q[l].T @ A[l] @ Q[(l + 1) % p] - H[l]
        assert float(R.abs().max()) <= 2e-13 * scale
        assert float((Q[l].T @ Q[l] - eye).abs().max()) <= 10 * np.finfo(float).eps * n
    Hn, Qn = hessenberg.phessenberg_core(A, want_q=False)
    assert Qn is None and torch.equal(Hn, H)


def _hess_cycle(p, n, kind, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, n, n))
    if kind == "real":
        return A
    A = A + 1j * rng.standard_normal((p, n, n))
    if kind == "zero_tails":  # zero tails, complex diagonals: every tau != 0
        A = np.triu(A)
        A[0] += np.diag(rng.standard_normal(n - 1) + 1j * rng.standard_normal(n - 1), -1)
    return A


@pytest.mark.parametrize("p,n,kind,want_q", [
    (1, 1, "real", True), (1, 2, "real", True), (1, 3, "real", False), (2, 3, "real", True),
    (1, 1, "complex", True), (1, 2, "complex", True), (1, 3, "complex", True),
    (3, 3, "complex", False), (1, 33, "complex", True), (4, 64, "complex", True),
    (16, 128, "complex", False), (3, 40, "zero_tails", True), (1, 40, "zero_tails", True)])
def test_hess_kernel_edges_and_complex_match_plain(cuda, p, n, kind, want_q):
    """Both instances against the plain version: 1e-12 max|A| (H) and 1e-12
    (Q), residual 2e-13 max|A|, orthonormality 10 eps n, exact zeros; one
    launch per reduction (none for n == 1)."""
    A = torch.tensor(_hess_cycle(p, n, kind, 1000 * p + n + 7), device=cuda)
    before = hessenberg.launches["hess_reduce"]
    H, Q = hessenberg.phessenberg_core(A, want_q=want_q)
    assert hessenberg.launches["hess_reduce"] - before == (1 if n > 1 else 0)
    Hp, Qp = hessenberg.phessenberg_core_plain(A, want_q=want_q)
    torch.cuda.synchronize()
    scale = float(A.abs().max())
    assert float((H - Hp).abs().max()) <= 1e-12 * scale
    _structure_exact(H)
    if not want_q:
        assert Q is None
        Hq, Q = hessenberg.phessenberg_core(A)
        assert torch.equal(Hq, H)
    else:
        assert float((Q - Qp).abs().max()) <= 1e-12
    eye = torch.eye(n, dtype=A.dtype, device=cuda)
    for l in range(p):
        R = Q[l].mH @ A[l] @ Q[(l + 1) % p] - H[l]
        assert float(R.abs().max()) <= 2e-13 * scale
        assert float((Q[l].mH @ Q[l] - eye).abs().max()) <= 10 * np.finfo(float).eps * n


@pytest.mark.parametrize("dtype", [torch.complex64, torch.float32])
def test_hess_kernel_refuses_single_precision(cuda, dtype):
    A = torch.tensor(_hess_cycle(2, 5, "complex", 3), device=cuda)
    A = A.to(dtype) if dtype.is_complex else A.real.to(dtype)
    before = hessenberg.launches["hess_reduce"]
    with pytest.raises(ValueError, match="float64 or complex128"):
        hessenberg.phessenberg_core(A)
    assert hessenberg.launches["hess_reduce"] == before


ALT4 = (True, False, True, False)


def _signed_cycle(S, n, kind, seed):
    """A cycle for the signed reduction; "zero": the last factor (inverted
    in ALT4) triangular with an exact zero on its diagonal, which stage 1
    keeps."""
    rng = np.random.default_rng(seed)
    p = len(S)
    A = rng.standard_normal((p, n, n))
    if kind == "complex":
        A = A + 1j * rng.standard_normal((p, n, n))
    if kind == "zero":
        A[p - 1] = np.triu(A[p - 1])
        A[p - 1, 2, 2] = 0.0
    return A


@pytest.mark.parametrize("S,n,kind,want_q", [
    ((True, False), 3, "real", True), ((True, False), 3, "complex", True),
    ((True, False, False), 37, "real", True), ((True, False, False), 37, "complex", True),
    (ALT4, 64, "real", True), (ALT4, 64, "complex", True),
    ((True, True, True), 40, "real", True), ((True, True, True), 40, "complex", True),
    ((True,), 20, "real", True), (ALT4, 9, "zero", True),
    (ALT4, 64, "real", False), ((True, False, False), 37, "complex", False)])
def test_hess_signed_kernel_matches_plain(cuda, S, n, kind, want_q):
    """Stage 2 on the card against phessenberg_signed_core_plain: one launch
    per reduction, the input unchanged, exact zeros, the similarity
    contract; want_q=False gives the same H."""
    p = len(S)
    A = torch.tensor(_signed_cycle(S, n, kind, 100 * p + n), device=cuda)
    A0 = A.clone()
    before = hessenberg.launches["hess_signed"]
    H, Q = hessenberg.phessenberg_signed_core(A, S, want_q=want_q)
    assert hessenberg.launches["hess_signed"] - before == 1
    assert torch.equal(A, A0)
    Hp, Qp = hessenberg.phessenberg_signed_core_plain(A, S, want_q=want_q)
    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal((p, n, n)),
                        device=cuda)
    Hs, Qs = hessenberg.phessenberg_signed_core_plain(A * pert, S, want_q=want_q)
    scale = float(A.abs().max())
    tol_h = max(1e-12, 10 * float((Hs - Hp).abs().max()) / scale)
    assert float((H - Hp).abs().max()) <= tol_h * scale
    _structure_exact(H)
    if not want_q:
        assert Q is None
        Hq, Q = hessenberg.phessenberg_signed_core(A, S)
        assert torch.equal(Hq, H)
    else:
        tol_q = max(1e-12, 10 * float((Qs - Qp).abs().max()))
        assert float((Q - Qp).abs().max()) <= tol_q
    for l in range(p):
        a, b = (l, (l + 1) % p) if S[l] else ((l + 1) % p, l)
        R = Q[a].mH @ A[l] @ Q[b] - H[l]
        assert float(R.abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_hess_signed_stage2_makes_no_host_sync(cuda, kind):
    A = torch.tensor(_signed_cycle(ALT4, 48, kind, 9), device=cuda)
    H, Q = hessenberg.phessenberg_signed_core(A, ALT4)   # builds; caches the signature
    H1, Q1 = hessenberg._signed_stage1(A, ALT4, True)
    sig = sweep_cx._signature(ALT4, A.device)
    torch.cuda.synchronize()
    before = hessenberg.launches["hess_signed"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        hessenberg.signed_stage2_cuda(H1, Q1, sig)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert hessenberg.launches["hess_signed"] - before == 1
    assert torch.equal(hessenberg._scrub(H1), H) and torch.equal(Q1, Q)


@pytest.mark.parametrize("n", [1, 2])
def test_hess_signed_launches_nothing_without_chains(cuda, n):
    A = torch.tensor(_signed_cycle(ALT4, n, "complex", 4), device=cuda)
    before = hessenberg.launches["hess_signed"]
    H, Q = hessenberg.phessenberg_signed_core(A, ALT4)
    assert hessenberg.launches["hess_signed"] == before
    Hp, Qp = hessenberg.phessenberg_signed_core_plain(A, ALT4)
    assert torch.equal(H, Hp) and torch.equal(Q, Qp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_hess_signed_refuses_single_precision(cuda, dtype):
    A = torch.tensor(_signed_cycle(ALT4, 6, "complex", 3), device=cuda)
    A = A.to(dtype) if dtype.is_complex else A.real.to(dtype)
    before = hessenberg.launches["hess_signed"]
    with pytest.raises(ValueError, match="float64 or complex128"):
        hessenberg.phessenberg_signed_core(A, ALT4)
    assert hessenberg.launches["hess_signed"] == before


def _deflate_cycle(S, n, kind, seed, zero=None):
    """A periodic Hessenberg-triangular cycle and unitary Z of the scalar
    kind "real" or "complex"; zero = (l, j) plants an exact zero at
    H[l][j, j]."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if kind == "complex" else x
    H = np.stack([np.triu(draw(n, n), -1 if l == 0 else 0) for l in range(len(S))])
    if zero is not None:
        H[zero[0], zero[1], zero[1]] = 0.0
    Z = np.stack([np.linalg.qr(draw(n, n))[0] for _ in S])
    return H, Z


# (action, S, n, window): (jlo, ldef, jdef, ilast) or CZSHIFT's (jlo, ilast);
# "czshift_zero" plants an exact zero on the direct factor 2's diagonal
# inside the window, so CZSHIFT takes its identity branch
DEFLATE_CASES = {
    "pos": ("pos", (True, False, True, True), 48, (0, 2, 20, 47)),
    "pos_edges": ("pos", (True, True, False), 40, (3, 1, 39, 39)),
    "neg_down": ("neg", ALT4, 48, (0, 1, 40, 47)),
    "neg_up": ("neg", ALT4, 48, (5, 3, 9, 47)),
    "neg_edge": ("neg", (True, True, False), 40, (0, 2, 39, 39)),
    "czshift": ("czshift", (True, False, True, True, False), 64, (0, 63)),
    "czshift_inner": ("czshift", ALT4, 64, (7, 50)),
    "czshift_zero": ("czshift", ALT4, 64, (7, 50)),
    # odd n: the complex rotations' storage must stay 16-byte aligned
    "pos_odd": ("pos", ALT4, 47, (0, 2, 20, 46)),
    "neg_odd": ("neg", ALT4, 47, (0, 1, 30, 46)),
    "czshift_odd": ("czshift", ALT4, 47, (0, 46)),
}


def _deflate_run(cuda, case, kind, want_z=True):
    """One case through the kernel and the plain version on the card; returns
    (H0, (H, Z, zflag) of the kernel, of the plain version, tolerance)."""
    action, S, n, args = DEFLATE_CASES[case]
    zero = ((2, 20) if case == "czshift_zero" else None) if action == "czshift" \
        else (args[1], args[2])
    Hn, Zn = _deflate_cycle(S, n, kind, 11 * n + len(case), zero)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    eps = float(np.finfo(np.float64).eps)
    cores = pqz_deflate.DeflateCores(len(S), S, want_z, eps,
                                     float(np.finfo(np.float64).tiny) * n / eps)

    def run(route, H):
        H, Z = H.clone(), Z0.clone()
        out = getattr(cores, f"{action}_core{route}")(H, Z, *args)
        return H, Z, (out[2] if action == "czshift" else None)
    before = pqz_deflate.launches[f"deflate_{action}"]
    kern = run("", H0)
    assert pqz_deflate.launches[f"deflate_{action}"] - before == 1
    plain = run("_plain", H0)
    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(H0.shape),
                        device=cuda)
    Hs, Zs, _ = run("_plain", H0 * pert)
    scale = float(H0.abs().max())
    sens = max(float((Hs - plain[0]).abs().max()) / scale,
               float((Zs - plain[1]).abs().max()) if want_z else 0.0)
    return H0, Z0, kern, plain, max(1e-12, 10 * sens)


@pytest.mark.parametrize("case", list(DEFLATE_CASES))
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_deflate_kernels_match_plain(cuda, kind, case):
    """Each deflation action of csrc/pqz_deflate.cu against its plain
    version on the card: one launch per call, H and Z within the gate, the
    plain version's exact zeros (a kernel-only zero where |plain| is at
    rounding level: a fused product can round an entry that is zero in
    exact arithmetic to exactly 0) and the same flag."""
    H0, Z0, (H, Z, f), (Hp, Zp, fp), tol = _deflate_run(cuda, case, kind)
    scale = float(H0.abs().max())
    assert float((H - Hp).abs().max()) <= tol * scale
    assert float((Z - Zp).abs().max()) <= tol
    zk, zp = H == 0, Hp == 0   # the plain version's zeros, and others only at rounding level
    assert bool(zk[zp].all()) and bool((Hp[zk & ~zp].abs() <= tol * scale).all())
    assert f == fp
    if case.startswith("czshift"):
        assert f == (case == "czshift_zero")


def test_deflate_kernel_without_z(cuda):
    _, Z0, (H, Z, f), (Hp, _, fp), tol = _deflate_run(cuda, "czshift_zero", "complex",
                                                       want_z=False)
    assert torch.equal(Z, Z0) and f and fp
    assert float((H - Hp).abs().max()) <= tol * float(Hp.abs().max())


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_deflate_kernel_global_rotations(cuda, kind):
    # the rotations go to the global scratch ws where they do not fit the
    # shared memory a block may take: the first odd n past it, p=2, windows
    # of 40 rows at the bottom (the storage is sized by n, not the window);
    # Z the identity; gated at 1e-12
    optin = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    n = (optin // (24 if kind == "complex" else 16) + 1) | 1
    g = torch.Generator(device=cuda).manual_seed(8)
    dt = torch.complex128 if kind == "complex" else torch.float64
    H0 = torch.randn((2, n, n), generator=g, device=cuda, dtype=dt)
    H0[0] = torch.triu(H0[0], -1)
    H0[1] = torch.triu(H0[1])
    S = (True, True)
    eps = float(np.finfo(np.float64).eps)
    cores = pqz_deflate.DeflateCores(2, S, True, eps, float(np.finfo(np.float64).tiny) * n / eps)
    scale = float(H0.abs().max())
    for action, args in (("czshift", (n - 40, n - 1)), ("pos", (n - 40, 1, n - 20, n - 1))):
        H0c = H0.clone()
        if action == "pos":
            H0c[1, n - 20, n - 20] = 0.0
        out = {}
        for route in ("", "_plain"):
            H = H0c.clone()
            Z = torch.eye(n, dtype=dt, device=cuda).expand(2, n, n).clone()
            before = pqz_deflate.launches[f"deflate_{action}"]
            res = getattr(cores, f"{action}_core{route}")(H, Z, *args)
            assert pqz_deflate.launches[f"deflate_{action}"] - before == (route == "")
            out[route] = (H, Z, res[2] if action == "czshift" else None)
            del H, Z
        (H, Z, f), (Hp, Zp, fp) = out[""], out["_plain"]
        assert float((H - Hp).abs().max()) <= 1e-12 * scale
        assert float((Z - Zp).abs().max()) <= 1e-12 and f == fp
        zk, zp = H == 0, Hp == 0
        assert bool(zk[zp].all()) and bool((Hp[zk & ~zp].abs() <= 1e-12 * scale).all())
        del out, H, Z, Hp, Zp, zk, zp, H0c


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_pschur_takes_the_deflation_kernels(cuda, kind):
    """pschur(A, 'R', S) at odd n on the card: a cycle whose reduction keeps
    two planted exact zeros (chip_smoke.singular_cycle) takes DEFLATE_POS
    and DEFLATE_NEG, and complex draws take CZSHIFT; each action is one
    launch."""
    from chip_smoke import singular_cycle
    p = 8
    S = tuple(l % 2 == 0 for l in range(p))
    core = pqz_complex if kind == "complex" else pqz_real
    draws = [singular_cycle(kind, p, 33, 5)]
    for n, seed in ((23, 777), (31, 1)) if kind == "complex" else ():
        rng = np.random.default_rng(seed)
        draws.append(rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n)))
    taken = {"czshift": 0, "deflate_pos": 0, "deflate_neg": 0}
    for A in draws:
        before = dict(pqz_deflate.launches)
        P = pt.pschur(torch.tensor(A, device=cuda), "R", S=S)
        info = core.last_info
        for k in taken:
            key = "deflate_czshift" if k == "czshift" else k
            assert pqz_deflate.launches[key] - before[key] == info[k]
            taken[k] += info[k]
        ok, rep = pt.check_psd(P, A, tol=200.0)
        assert ok, rep
    assert taken["deflate_pos"] >= 1 and taken["deflate_neg"] >= 1
    if kind == "complex":
        assert taken["czshift"] >= 1


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_deflate_reads_nothing_back_but_czshift_flag(cuda, kind):
    import warnings
    S, n = ALT4, 32
    Hn, Zn = _deflate_cycle(S, n, kind, 5, (1, 9))
    H, Z = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    eps = float(np.finfo(np.float64).eps)
    cores = pqz_deflate.DeflateCores(len(S), S, True, eps,
                                     float(np.finfo(np.float64).tiny) * n / eps)
    cores.czshift_core(H.clone(), Z.clone(), 0, n - 1)   # builds; caches the signature
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cores.neg_core(H, Z, 0, 1, 9, n - 1)
        cores.pos_core(H, Z, 0, 2, 20, n - 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cores.czshift_core(H, Z, 0, n - 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert len([w for w in seen if "synchroniz" in str(w.message)]) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_deflate_refuses_single_precision(cuda, dtype):
    Hn, Zn = _deflate_cycle(ALT4, 8, "complex", 3)
    H = torch.tensor(Hn, device=cuda)
    H = H.to(dtype) if dtype.is_complex else H.real.to(dtype)
    cores = pqz_deflate.DeflateCores(4, ALT4, False, 1e-16, 1e-300)
    before = dict(pqz_deflate.launches)
    for call in (lambda: cores.czshift_core(H, None, 0, 7),
                 lambda: cores.pos_core(H, None, 0, 2, 3, 7),
                 lambda: cores.neg_core(H, None, 0, 1, 3, 7)):
        with pytest.raises(ValueError, match="float64 or complex128"):
            call()
    assert pqz_deflate.launches == before


@pytest.mark.parametrize("cfg", [AlgoConfig(), AlgoConfig(slicot_convg=True),
                                 AlgoConfig(slicot_shifts=True)],
                         ids=["default", "slicot_convg", "slicot_shifts"])
def test_glue_kernel_matches_plain_bitwise(cuda, cfg):
    p, n = 5, 40
    A = torch.tensor(np.random.default_rng(17).standard_normal((p, n, n)))
    H, _ = hessenberg.phessenberg_core_plain(A, want_q=False)
    Hp = torch.zeros((p, n + 1, n + 1), dtype=torch.float64)
    Hp[:, :n, :n] = H
    Hp[0, 21, 20] = 1e-17
    Hc = Hp.to(cuda)
    windows = [(0, n - 1, 1), (0, n - 1, 10), (4, 30, 16), (7, 33, 20), (22, 23, 3),
               (0, 0, 1)] + [((7 * i) % (i - 1), i, 1 + i % 20) for i in range(3, n)]
    for (l, i, its) in windows:
        before = glue.launches["glue"]
        k = glue.glue_cuda(Hc, n, l, i, its, cfg).cpu()
        assert glue.launches["glue"] == before + 1
        assert torch.equal(k, glue.glue_plain(Hc, n, l, i, its, cfg).cpu())
        assert torch.equal(k, glue.glue_plain(Hp, n, l, i, its, cfg))


def _glue_cycle(p, n, seed, hit=None):
    """A padded Hessenberg-triangular cycle for kernel G (triangular
    diagonals of modulus 1..2), H[0]'s subdiagonal negligible at ``hit``."""
    rng = np.random.default_rng(seed)
    Hp = torch.zeros((p, n + 1, n + 1), dtype=torch.float64)
    Hp[0, :n, :n] = torch.triu(torch.tensor(rng.standard_normal((n, n))), -1)
    for f in range(1, p):
        Hp[f, :n, :n] = torch.triu(torch.tensor(rng.standard_normal((n, n))))
        Hp[f, torch.arange(n), torch.arange(n)] = torch.tensor(1.0 + rng.random(n))
    if hit is not None:
        Hp[0, hit, hit - 1] = 1e-60
    return Hp


@pytest.mark.parametrize("p,n", [(1, 1100), (40, 1100), (2, 3000)])
def test_glue_kernel_past_the_block_bitwise(cuda, p, n):
    # many blocks (35 and 94), the last to finish taking the shift
    Hp = _glue_cycle(p, n, 7 * p + n, hit=700)
    Hc = Hp.to(cuda)
    for cfg in (AlgoConfig(), AlgoConfig(slicot_convg=True), AlgoConfig(slicot_shifts=True)):
        for (l, i, its) in [(0, n - 1, 1), (650, n - 1, 10), (0, 699, 16), (0, 0, 1),
                            (5, 5, 20), (300, n - 1, 20), (699, 701, 3)]:
            k = glue.glue_cuda(Hc, n, l, i, its, cfg).cpu()
            assert torch.equal(k, glue.glue_plain(Hp, n, l, i, its, cfg)), (l, i, its)
    assert int(glue.glue_cuda(Hc, n, 0, n - 1, 1, AlgoConfig())[0]) == 700


def test_glue_calls_keep_their_arrays(cuda):
    # two calls on other (p, n), each with its buffers: the first call's
    # Glue still holds its values
    first = None
    for (p, n) in [(3, 20), (4, 24)]:
        Hc = _glue_cycle(p, n, p, hit=n // 2).to(cuda)
        bufs = glue.glue_buffers(Hc, n)
        g = glue.glue_products_scan_shift(Hc, n, 0, n - 1, 1, AlgoConfig(), bufs)
        ref = glue.unpack(glue.glue_plain(Hc.cpu(), n, 0, n - 1, 1, AlgoConfig()).numpy(), p,
                          n, n - 1)
        if first is None:
            first = (g, ref, bufs)
    g, ref, bufs = first
    assert g.lnew == ref.lnew == 10 and g.v0 == ref.v0
    for a, b in zip(g[2:], ref[2:]):
        assert np.array_equal(a, b)
    assert not g.D.flags.writeable and not g.U.flags.writeable
    # a CUDA stack takes buffers of its own (card, p, n) only
    for other in (None, bufs):
        with pytest.raises(ValueError, match="glue_buffers"):
            glue.glue_products_scan_shift(Hc, n, 0, n - 1, 1, AlgoConfig(), other)


def test_glue_on_two_streams_at_once(cuda):
    """Two problems of other sizes, each taking kernel G into its own
    NaN-filled buffer 64 times on its own stream, queued behind a spin on
    both streams so that the two streams' launches run at once: every
    packed buffer is glue_plain's, bit for bit (the last block to finish,
    found by a counter in the scratch that each launch zeroes first, takes
    the shift)."""
    cases = []
    for (p, n, hit) in [(16, 512, 300), (5, 200, 77)]:
        Hp = _glue_cycle(p, n, p + n, hit=hit)
        k = glue.out_len(p, n)
        outs = [torch.full((k + 3 * n,), float("nan"), dtype=torch.float64, device=cuda)
                for _ in range(64)]
        cases.append((Hp, Hp.to(cuda), p, n, k, outs, torch.cuda.Stream(cuda)))
    torch.cuda.synchronize()
    for (_, Hc, p, n, k, outs, st) in cases:
        with torch.cuda.stream(st):
            torch.cuda._sleep(20_000_000)
            for t, out in enumerate(outs):
                glue._launch(Hc, p, n, t % 7, n - 1 - t % 3, 1 + t % 20, AlgoConfig(),
                             out.data_ptr(), st.cuda_stream)
    torch.cuda.synchronize()
    for (Hp, _, p, n, k, outs, _) in cases:
        for t, out in enumerate(outs):
            ref = glue.glue_plain(Hp, n, t % 7, n - 1 - t % 3, 1 + t % 20, AlgoConfig())
            assert torch.equal(out[:k].cpu(), ref), t


def test_real_cores_on_two_threads_at_once(cuda):
    """Two runs of pqr_real_core at one (p, n) on two threads of one card,
    each thread on its own stream, give what they give one after the other,
    bit for bit: each run reads kernel G through buffers of its own."""
    import threading
    runs = []
    for seed in (31, 32):
        A = np.random.default_rng(seed).standard_normal((4, 48, 48))
        H, Q = hessenberg.phessenberg_core(torch.tensor(A, device=cuda))
        runs.append((H, Q))
    alone = [pqr_real.pqr_real_core(H, Z=Q, with_info=True) for (H, Q) in runs]
    torch.cuda.synchronize()
    both = [None, None]
    errors = []

    def run(k):
        try:
            st = torch.cuda.Stream(cuda)
            with torch.cuda.stream(st):
                H, Q = runs[k]
                st.wait_stream(torch.cuda.default_stream(cuda))
                both[k] = pqr_real.pqr_real_core(H, Z=Q, with_info=True)
                st.synchronize()
        except BaseException as e:  # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for out, ref in zip(both, alone):
        assert out[4] and ref[4] and out[5]["niter"] == ref[5]["niter"]
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        assert np.array_equal(out[2], ref[2]) and np.array_equal(out[3], ref[3])


@pytest.mark.parametrize("p", [33, 40])
def test_cx_shift_kernel_many_factors(cuda, p):
    Hn, _, _ = _cx_problem(p, 16, 30 + p)
    H = torch.tensor(Hn, device=cuda)
    for S in (tuple(l % 2 == 0 for l in range(p)), (True,) * p, (True,) + (False,) * (p - 1)):
        for (a, b) in [(0, 15), (3, 9), (7, 8)]:
            ck = sweep_cx.qz_shift(H, a, b, S)
            cp = sweep_cx.qz_shift_plain(H, a, b, S)
            assert float((ck - cp).abs().max()) <= 1e-14


def test_core_with_glue_on_the_card(cuda, monkeypatch):
    from torch_glue_host import host_glue
    A = np.random.default_rng(23).standard_normal((3, 24, 24))
    H, Q = hessenberg.phessenberg_core(torch.tensor(A, device=cuda))
    before = glue.launches["glue"]
    out = pqr_real.pqr_real_core(H, Z=Q, with_info=True)
    assert glue.launches["glue"] - before == out[5]["niter"]
    monkeypatch.setattr(pqr_real, "glue_products_scan_shift", host_glue)
    ref = pqr_real.pqr_real_core(H, Z=Q, with_info=True)
    assert ref[4] and out[4] and out[5] == ref[5]
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert np.array_equal(out[2], ref[2]) and np.array_equal(out[3], ref[3])


def test_aed_apply_on_the_card_matches_the_cpu(cuda):
    from periodicschurdecompositions_jl_torch.ops import aed
    rng = np.random.default_rng(24)
    p, n, w, s = 3, 40, 12, 20
    N = n + 1
    H = np.zeros((p, N, N))
    for l in range(p):
        H[l, :n, :n] = np.triu(rng.standard_normal((n, n)), -1 if l == 0 else 0)
    H[0, s + w, s + w - 1] = 0.0
    Z = np.zeros((p, N, N))
    Z[:, :n, :n] = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(p)])
    Zt = np.stack([np.linalg.qr(rng.standard_normal((w, w)))[0] for _ in range(p)])
    Wf = np.stack([np.triu(rng.standard_normal((w, w)), -1 if l == 0 else 0) for l in range(p)])
    sph = np.zeros(w)
    sph[0] = 0.75
    outs = []
    for dev in (torch.device("cpu"), cuda):
        Hp, Zp = torch.tensor(H, device=dev), torch.tensor(Z, device=dev)
        aed.aed_apply(Hp, Zp, s, *(torch.tensor(x, device=dev) for x in (Zt, Wf, sph)))
        outs.append((Hp.cpu(), Zp.cpu()))
    (Hc, Zc), (Hg, Zg) = outs
    assert float((Hg - Hc).abs().max()) <= 1e-13 * float(Hc.abs().max())
    assert float((Zg - Zc).abs().max()) <= 1e-13
    assert torch.equal(Hg == 0, Hc == 0)  # the same exact zeros


def test_aed_driver_on_the_card(cuda):
    from periodicschurdecompositions_jl_torch.ops import aed
    A = np.random.default_rng(70).standard_normal((3, 40, 40))
    H, Q = hessenberg.phessenberg_core(torch.tensor(A, device=cuda))
    cfg = AlgoConfig(aed_window=12, aed_interval=8)
    before = dict(glue.launches)
    T, Z, wr, wi, ok, info = pqr_real.pqr_real_core_aed(H, Z=Q, cfg=cfg, with_info=True)
    assert ok and info["aed_deflated"] > 0
    assert glue.launches["glue"] - before["glue"] == info["niter"]
    assert T.device.type == "cuda" and Z.device.type == "cuda"
    w = np.sort_complex(wr + 1j * wi)
    ref = np.sort_complex(np.linalg.eigvals(A[0] @ A[1] @ A[2]))
    assert np.abs(w - ref).max() <= 1e-10 * np.abs(ref).max()
    P = pt.PeriodicSchur(Ts=T, Zs=Z, values=torch.complex(torch.tensor(wr),
                                                          torch.tensor(wi)))
    good, rep = pt.check_psd(P, A, qtol=10.0, tol=40.0)
    assert good, rep
    assert aed.stats["deflated"] > 0


@pytest.mark.parametrize("cplx", [False, True], ids=["float64", "complex128"])
def test_signed_aed_apply_on_the_card_matches_the_cpu(cuda, cplx):
    from periodicschurdecompositions_jl_torch.ops import aed
    rng = np.random.default_rng(26)
    p, n, w, s, S = 3, 40, 12, 20, (True, False, True)

    def m(*shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if cplx else x

    H = np.stack([np.triu(m(n, n), -1 if l == 0 else 0) for l in range(p)])
    H[0, s + w, s + w - 1] = 0.0
    Z = np.stack([np.linalg.qr(m(n, n))[0] for _ in range(p)])
    Zt = np.stack([np.linalg.qr(m(w, w))[0] for _ in range(p)])
    Wf = np.stack([np.triu(m(w, w), -1 if l == 0 else 0) for l in range(p)])
    sph = np.zeros(w, H.dtype)
    sph[0] = 0.75
    outs = []
    for dev in (torch.device("cpu"), cuda):
        Hp, Zp = torch.tensor(H, device=dev), torch.tensor(Z, device=dev)
        aed.aed_apply(Hp, Zp, s, *(torch.tensor(x, device=dev) for x in (Zt, Wf, sph)), S)
        outs.append((Hp.cpu(), Zp.cpu()))
    (Hc, Zc), (Hg, Zg) = outs
    assert float((Hg - Hc).abs().max()) <= 1e-13 * float(Hc.abs().max())
    assert float((Zg - Zc).abs().max()) <= 1e-13
    assert torch.equal(Hg == 0, Hc == 0)  # the same exact zeros


@pytest.mark.parametrize("route", ["rg", "cx"])
def test_signed_aed_drivers_on_the_card(cuda, route):
    from periodicschurdecompositions_jl_torch.ops import aed
    cplx = route == "cx"
    S = (True, False) if cplx else (True, False, True)
    rng = np.random.default_rng(56)
    A = rng.standard_normal((len(S), 36, 36))
    if cplx:
        A = A + 1j * rng.standard_normal(A.shape)
    H, Q = hessenberg.phessenberg_signed_core(torch.tensor(A, device=cuda), S)
    cfg = AlgoConfig(aed_window=10, aed_interval=8)
    core, drive = ((pqz_complex.pqz_complex_core, pqz_complex.pqz_complex_core_aed) if cplx
                   else (pqz_real.pqz_real_gen_core, pqz_real.pqz_real_gen_core_aed))
    seen = {"n": 0}
    reduce = aed._phess_window_signed

    def counted(Aw, *a, **k):
        seen["n"] += Aw.shape[-1] > 2  # stage 2 launches at n > 2
        return reduce(Aw, *a, **k)
    before = hessenberg.launches["hess_signed"]
    aed._phess_window_signed = counted
    try:
        out = drive(H, S, Z=Q, cfg=cfg, with_info=True)
    finally:
        aed._phess_window_signed = reduce
    info = out[-1]
    assert out[-2] and info["aed_deflated"] > 0
    assert hessenberg.launches["hess_signed"] - before == seen["n"]
    T, Z = out[0].cpu().numpy(), out[1].cpu().numpy()
    for l in range(len(S)):
        ln = (l + 1) % len(S)
        Ax = Z[l] @ T[l] @ Z[ln].conj().T if S[l] else Z[ln] @ T[l] @ Z[l].conj().T
        assert np.abs(Ax - A[l]).max() < 1e-11 * 36 * np.abs(A).max()

    def values(o):
        f = [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in o[2:-2]]
        if cplx:
            return f[0] / f[1] * np.exp2(f[2].astype(float))
        return (f[0] + 1j * f[1]) / f[2] * np.exp2(f[3].astype(float))
    ref = values(core(H.cpu(), S, Z=Q.cpu(), with_info=True))
    d = np.abs(values(out)[:, None] - ref[None, :])
    assert max(d.min(axis=1).max(), d.min(axis=0).max()) < 1e-8 * max(1.0, np.abs(ref).max())


def test_ordschur_and_eigvecs_keep_the_card(cuda):
    A = np.random.default_rng(25).standard_normal((3, 16, 16))
    P = pt.pschur(torch.tensor(A, device=cuda), "R")
    select = [j in (3, 11) for j in range(16)]
    P2 = pt.ordschur(P, select)
    assert all(t.device.type == "cuda" for t in (P2.Ts, P2.Zs, P2.values))
    Pc = pt.PeriodicSchur(Ts=P.Ts.cpu(), Zs=P.Zs.cpu(), values=P.values.cpu())
    P2c = pt.ordschur(Pc, select)
    assert torch.equal(P2.Ts.cpu(), P2c.Ts) and torch.equal(P2.Zs.cpu(), P2c.Zs)
    good, rep = pt.check_psd(P2, A, tol=2000.0)
    assert good, rep
    Vs = pt.eigvecs(P, select)
    assert len(Vs) == 3 and all(v.device.type == "cuda" for v in Vs)


@pytest.mark.parametrize("kind,nb", [("real", 1), ("real", 4), ("cx", 1), ("rg", 1)])
def test_apply_kernels_bounded(cuda, kind, nb):
    """B0 and B with the want_t=False bound (chip_smoke.py::apply_bound_case):
    bit for bit the unbounded launch inside the window, the input outside,
    Z bit for bit, B without Z leaving H as with Z, and the bounded plain
    version within 1e-13; at the main path's shapes (real p=16 n=512, cx
    and rg p=8 n=256, alternating S), rlo odd and off the tiles' grid."""
    from chip_smoke import (alternating, apply_bound_case, mk_cx_problem, mk_rg_problem,
                            mk_sweep_problem, random_logs)
    rng = np.random.default_rng(22)
    if kind == "real":
        p, n, m, i, rlo = 16, 512, 101, 480, 77
        Hn, Zn, v0 = mk_sweep_problem(p, n, rng)
        H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
        H0[0, m, m - 1] = 0.0
        H0[0, i + 1, i] = 0.0
        R = (sweep.sweep_generate(H0, m, i, v0) if nb == 1 else
             torch.tensor(random_logs("real", p, n, m, i, rng, nb), device=cuda))
    else:
        p, n, S = 8, 256, alternating(8)
        m, i, rlo = (37, 200, 21) if kind == "cx" else (38, 200, 37)
        Hn, Zn, extra = (mk_cx_problem if kind == "cx" else mk_rg_problem)(p, n, rng)
        H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
        if kind == "cx":
            H0[0, m, m - 1] = 0.0
            R = sweep_cx.qz_sweep_generate(H0, m, i, torch.tensor(extra, device=cuda), S)
        else:
            H0[0, m - 1, m - 2] = 0.0
            rgopen.rg_ladder_plain(H0, Z0, "open", m - 1, i, torch.tensor(extra, device=cuda),
                                   S, want_z=True)
            R = sweep_rg.rg_sweep_generate(H0, m, i, S)
        H0[0, i + 1, i] = 0.0
    d, _ = apply_bound_case(cuda, kind, H0, Z0, R, m, i, rlo, i + 1, nb)
    assert d <= 1e-13


@pytest.mark.parametrize("label", ["chainA", "chainB", "chainB-jmax"])
def test_deflate_kernel_bounded(cuda, label):
    """Kernel D with the want_t=False bound at p=16 n=512: the 2x2 window
    alone (rlo = i - 1, chi = i + 1) and a wider window (rlo = 37, chi = i +
    9): bit for bit the unbounded launch inside, untouched outside, Z bit
    for bit, H without Z as with Z; the bounded plain version within 1e-12."""
    from chip_smoke import bounded_ok, deflate_cases, deflate_scalars
    (_, Hn, Zn, i), = [c for c in deflate_cases(16, 512) if c[0] == label]
    sc = deflate_scalars(Hn, i)
    args = (i, sc["jmin"], sc["jmax"], sc["cs0"], sc["sn0"], sc["replace0"], sc["finzero"],
            sc["thr"])
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    Hu, Zu = H0.clone(), Z0.clone()
    deflate.deflate2x2(Hu, Zu, *args, want_z=True)
    for rlo, chi in ((i - 1, i + 1), (37, i + 9)):
        Hb, Zb, Hz = H0.clone(), Z0.clone(), H0.clone()
        deflate.deflate2x2(Hb, Zb, *args, want_z=True, rhi=chi, clo=rlo)
        deflate.deflate2x2(Hz, None, *args, want_z=False, rhi=chi, clo=rlo)
        assert bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb) and torch.equal(Hz, Hb)
        Hp, Zp = H0.clone(), Z0.clone()
        deflate.deflate2x2_plain(Hp, Zp, *args, want_z=True, rhi=chi, clo=rlo)
        assert float((Hb - Hp).abs().max()) <= 1e-12 * float(H0.abs().max())
        assert float((Zb - Zp).abs().max()) <= 1e-12


@pytest.mark.parametrize("route,want_z", [("real", True), ("real", False), ("complex", True),
                                          ("signed complex", True), ("rg", True),
                                          ("rg", False)])
def test_want_t_false_is_the_run_with_t(cuda, route, want_z):
    """pschur(want_t=False) on the card at p=4 n=200 (AED and the host tail
    on: n >= aed_min_n): niter, the AED tallies and the kernels' launches as
    with T, the eigenvalues and Z bit for bit."""
    rng = np.random.default_rng(200)
    A = rng.standard_normal((4, 200, 200))
    S = None if route in ("real", "complex") else (True, False, True, False)
    if "complex" in route:
        A = A + 1j * rng.standard_normal(A.shape)
    core = pqz_complex if "complex" in route else pqz_real if route == "rg" else pqr_real
    mods = (sweep_cx,) if "complex" in route else (sweep_rg, rgopen) if route == "rg" else (
        sweep, deflate, glue)
    At = torch.tensor(A, device=cuda)
    runs = []
    for want_t in (True, False):
        for mod in mods:
            for k in mod.launches:
                mod.launches[k] = 0
        P = pt.pschur(At, "R", S=S, want_t=want_t, want_z=want_z)
        info = {k: v for k, v in core.last_info.items()
                if k not in ("aed_s", "reduce_s", "iterate_s")}
        runs.append((P, info, {k: v for mod in mods for k, v in mod.launches.items()}))
    (P1, i1, l1), (P2, i2, l2) = runs
    assert i1 == i2 and l1 == l2
    assert i1["aed_events"] >= 1
    assert torch.equal(P1.values, P2.values)
    assert (P2.Zs is None) if not want_z else torch.equal(P1.Zs, P2.Zs)


@pytest.mark.parametrize("kind", ["real", "complex", "matrix_free"])
def test_krylov_partial_pschur_on_the_card_matches_the_cpu(cuda, kind):
    from torch_krylov_host import check_partial, mkmats
    cplx = kind == "complex"
    p, n, nev = (2, 24, 3) if cplx else (3, 30, 4)
    A = mkmats(np.random.default_rng(1234), p, n, cplx=cplx)
    pc, hc = pt.partial_pschur(torch.tensor(A), nev, "LM", seed=7)
    Ag = torch.tensor(A, device=cuda)
    if kind == "matrix_free":
        pg, hg = pt.partial_pschur([lambda x, a=Ag[l]: a @ x for l in range(p)], nev, "LM",
                                   n=n, dtype=torch.float64, seed=7)
    else:
        pg, hg = pt.partial_pschur(Ag, nev, "LM", seed=7)
    assert all(t.device.type == "cuda" for t in (pg.Ts, pg.Vs, pg.values, pg.residuals))
    assert hg.nconverged == hc.nconverged >= nev // 2
    a = np.sort_complex(pg.values.cpu().numpy())
    b = np.sort_complex(pc.values.numpy())
    assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    check_partial(lambda l, X: A[l] @ X, pg.Vs.cpu().numpy(), pg.Ts.cpu().numpy(), a)
    assert hg.host_reads >= hg.nprods


@pytest.mark.parametrize("cplx", [False, True])
def test_krylov_cycle_ops_step_on_the_card(cuda, cplx):
    rng = np.random.default_rng(21)
    n, w = 300, 12
    A = rng.standard_normal((2, n, n))
    V = [np.linalg.qr(rng.standard_normal((n, w + 1)))[0],
         np.linalg.qr(rng.standard_normal((n, w)))[0]]
    if cplx:
        A = A + 1j * rng.standard_normal(A.shape)
        V = [v.astype(complex) for v in V]
    x = np.linalg.solve(A[0], V[1] @ rng.standard_normal(w) + 1e-3 * rng.standard_normal(n))
    V[0][:, 4] = x / np.linalg.norm(x)      # the re-pass
    ops = CycleOps(torch.tensor(A, device=cuda))
    ops.load_basis(V)
    for l, j, lnext, ncols in ((0, 3, 1, 7), (0, 4, 1, w), (1, 2, 0, w + 1)):
        hh, vv, ww, ii = krylov._orth_step(V[lnext][:, :ncols], A[l] @ V[l][:, j])
        reads = ops.reads
        h, w_, inspan = ops.apply_orth(l, lnext, j, ncols, krylov.ETA_ORTH)
        assert ops.reads == reads + 1 and inspan == bool(ii) is False
        assert abs(w_ - ww) <= 1e-13 * max(ww, 1.0)
        assert np.abs(h - hh).max() <= 1e-13 * np.abs(hh).max()
        col = ops.accept(lnext, j, w_)
        assert np.abs(col - vv / ww).max() <= 1e-10
        V[lnext][:, j] = col


def _shards(N, D):
    b = [round(k * N / D) for k in range(D + 1)]
    return [(b[k], b[k + 1] - b[k]) for k in range(D)]


@pytest.mark.parametrize("p,n,m,i,nb,bounds", [
    (3, 63, 0, 62, 1, False), (2, 47, 5, 40, 1, True), (16, 40, 3, 30, 4, False),
    (1, 31, 1, 29, 1, False), (4, 70, 33, 68, 2, True)])
def test_shard_entries_are_b0_b_bit_for_bit(cuda, p, n, m, i, nb, bounds):
    N = n + 1
    Hn, Zn, v0 = _problem(p, n, p * 13 + n)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    if nb == 1:
        R = sweep.sweep_generate(H0, m, i, v0)
    else:
        q = np.linalg.qr(np.random.default_rng(n).standard_normal((nb, p, N, 3, 3)))[0]
        R = torch.tensor(q.reshape(nb, p, N, 9), device=cuda)
    rhi, clo = (i + 1, max(m - 3, 0)) if bounds else (None, None)
    for want_z in (True, False):
        Hu, Zu = H0.clone(), Z0.clone()
        sweep._apply_log(_cuda.load(), _cuda.stream_ptr(Hu), Hu, Zu, R, m, i, nb, want_z,
                         rhi, clo)
        for D in (1, 2, 4):
            Hs, Zs, Hp, Zp = H0.clone(), Z0.clone(), H0.clone(), Z0.clone()
            for c0, L in _shards(N, D):
                for X, plain in ((Hs, False), (Hp, True)):
                    Hc = X[:, :, c0:c0 + L].contiguous()
                    if plain:
                        sweep.apply_log_shard_plain(Hc, None, R, m, i, side="left", offset=c0,
                                                    nb=nb, rhi=rhi)
                    else:
                        sweep.sweep_left_shard(Hc, R, m, i, c0, nb=nb, rhi=rhi)
                    X[:, :, c0:c0 + L] = Hc
            for r0, L in _shards(N, D):
                for X, Y, plain in ((Hs, Zs, False), (Hp, Zp, True)):
                    Hr, Zr = X[:, r0:r0 + L].contiguous(), Y[:, r0:r0 + L].contiguous()
                    if plain:
                        sweep.apply_log_shard_plain(Hr, Zr, R, m, i, side="right", offset=r0,
                                                    want_z=want_z, nb=nb, clo=clo)
                    else:
                        sweep.sweep_right_shard(Hr, Zr, R, m, i, r0, want_z=want_z, nb=nb,
                                                clo=clo)
                    X[:, r0:r0 + L], Y[:, r0:r0 + L] = Hr, Zr
            assert torch.equal(Hs, Hu) and torch.equal(Zs, Zu), (D, want_z)
            assert float((Hs - Hp).abs().max()) <= 1e-13 * float(H0.abs().max())
            assert float((Zs - Zp).abs().max()) <= 1e-13


def test_sharded_sweep_and_pschur_on_one_card(cuda):
    p, n, m, i = 3, 63, 2, 61
    Hn, Zn, v0 = _problem(p, n, 43)
    H0, Z0 = torch.tensor(Hn, device=cuda), torch.tensor(Zn, device=cuda)
    H0[0, m, m - 1] = 0.0
    Hu, Zu = H0.clone(), Z0.clone()
    sweep.chase_sweep(Hu, Zu, m, i, v0, want_z=True, early=True)
    for D in (2, 4, 8):
        Hs, Zs = H0.clone(), Z0.clone()
        pt.chase_sweep_sharded(Hs, Zs, m, i, v0, devices=[cuda] * D, want_z=True, early=True)
        assert torch.equal(Hs, Hu) and torch.equal(Zs, Zu), D
    A = torch.tensor(np.random.default_rng(3).standard_normal((3, 31, 31)), device=cuda)
    P = pqr_real.pschur_real_pipeline(A, "R", cfg=AlgoConfig(aed=False, host_tail=-1))
    for D in (2, 4):
        T, Z, w, ok = pt.pschur_real_sharded(A, [cuda] * D)
        assert ok and torch.equal(T, P.Ts) and torch.equal(Z, P.Zs)
        assert np.array_equal(w, P.values.cpu().numpy())


def test_ensemble_and_batches_on_the_card(cuda):
    rng = np.random.default_rng(99)
    As = [rng.standard_normal((4, 40, 40)) for _ in range(4)]
    seq = pt.ensemble_pschur_real_pipelined(As, device=cuda, workers=1)
    piped = pt.ensemble_pschur_real_pipelined(As, device=cuda, workers=3)
    for s, q in zip(seq, piped):
        assert s[4] and all(np.array_equal(x, y) for x, y in zip(s[:4], q[:4]))
    A = torch.tensor(np.stack(As), device=cuda)
    one = pt.batched_pschur_real(A, workers=1)
    two = pt.batched_pschur_real(A, mesh=[cuda, cuda], workers=2)
    assert bool(one[4].all()) and all(torch.equal(x, y) for x, y in zip(one, two))
    Ac = torch.tensor(np.stack(As) + 1j * rng.standard_normal((4, 4, 40, 40)), device=cuda)
    S = (True, False, True, False)
    one = pt.batched_pschur_complex(Ac, S, workers=1)
    two = pt.batched_pschur_complex(Ac, S, workers=2)
    assert bool(one[5].all()) and all(torch.equal(x, y) for x, y in zip(one, two))
    assert one[0].device == Ac.device


_HOSTILE = {}


def _hostile(k):
    if not _HOSTILE:
        from chip_smoke import hostile_rg_cases
        _HOSTILE.update(enumerate(hostile_rg_cases()))
    return _HOSTILE[k]


@pytest.mark.parametrize("k", range(33))
def test_hostile_rg_draws_on_the_card(cuda, k):
    # benchmarks/probe_rg_hostile.py's draws through pschur(A, 'R', S)
    from chip_smoke import hostile_rg_case
    tag, A, S = _hostile(k)
    n = A.shape[-1]
    niter, rc, nn, be, wall = hostile_rg_case(cuda, A, S)
    msg = f"{tag}: niter {niter} ({niter / n:.1f}n), native core rc {rc} niter {nn}"
    print(msg + ("  <-- BEYOND 60n" if niter > 60 * n else ""))
    assert niter <= 120 * n, msg
    assert be <= 1e-12, (msg, be)
