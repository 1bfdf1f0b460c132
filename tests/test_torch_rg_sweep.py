"""The PyTorch port's real generalized chase, ladders and 2x2 machinery.

No JAX core is compiled here.  Seeded numpy problems go through the port's
plain versions and through:

* the float64 numpy oracles of ``tests/test_pallas_rg.py`` (the glue
  opening and the interleaved chase): H within 5e-12 max|H|, Z within
  5e-12, exact structural zeros, the closing bulge H[0][i, i-2] kept;
* the Pallas kernels rg A/B0/B and R in interpret mode, one case each
  (ds arithmetic: within 1e-12 of the port's float64);
* the JAX package's ``qzrot2x2``, ``rp2x2ssr``, ``eig2x2_product`` and
  ``_opening_rotations`` (eager, float64): within 1e-13 (relative for the
  eigenvalues), the same ``done`` flag.

Also the real branch of ``DeflateCores`` and the regression test of the
JAX f64 route's factor-0 fault (see ``test_sweep_from_row_one_is_exact``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from periodicschurdecompositions_jl_tpu.ops import ff
from periodicschurdecompositions_jl_tpu.ops import pqz_real as jpr
from periodicschurdecompositions_jl_tpu.ops.pallas_rgopen import (rg_closing_ff,
                                                                  rg_opening_ff)
from periodicschurdecompositions_jl_tpu.ops.pallas_sweep_rg import rg_chase_sweep_ff
from periodicschurdecompositions_jl_torch.ops import pqz_real as tpr
from periodicschurdecompositions_jl_torch.ops import rgopen, sweep_rg
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_signed_core
from periodicschurdecompositions_jl_torch.ops.pqz_deflate import DeflateCores
from periodicschurdecompositions_jl_torch.ops.rotations import givens_host, givens_real
from periodicschurdecompositions_jl_torch.utils.interop import state_from_jax_ff
from test_pallas_rg import _mk_problem, _scrub, ref_chase_np, ref_opening_np

EPS = np.finfo(np.float64).eps
CASES = [(2, 10, (True, False), 0, 9), (2, 10, (True, True), 0, 9),
         (3, 12, (True, False, True), 0, 11), (3, 12, (True, True, False), 2, 9),
         (2, 8, (True, False), 2, 5)]


def _opened(p, n, S, ifirst, ilast):
    """test_pallas_rg's problem and the oracle's post-opening state."""
    rng = np.random.default_rng(p * 37 + n + sum(S))
    H, Z, rot = _mk_problem(p, n, S, rng, ilast)
    if ifirst > 0:
        H[0][ifirst, ifirst - 1] = 0.0
    Ho, Zo = ref_opening_np(H.copy(), Z.copy(), S, ifirst, ilast, *rot)
    return H, Z, rot, Ho, Zo


def _structure_ok(H, ilast):
    H0 = H[0].copy()
    assert H0[ilast, ilast - 2] != 0          # the closing bulge is kept
    H0[ilast, ilast - 2] = 0.0
    return (np.all(np.tril(H0, -2) == 0)
            and all(np.all(np.tril(H[f], -1) == 0) for f in range(1, H.shape[0])))


@pytest.mark.parametrize("p,n,S,ifirst,ilast", CASES)
def test_opening_and_chase_match_oracles(p, n, S, ifirst, ilast):
    H, Z, rot, Ho, Zo = _opened(p, n, S, ifirst, ilast)
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    rgopen.rg_ladder(Ht, Zt, "open", ifirst, ilast, torch.tensor(rot), S, want_z=True)
    scale = np.abs(Ho).max()
    assert np.abs(Ht.numpy() - Ho).max() <= 5e-12 * scale
    assert np.abs(Zt.numpy() - Zo).max() <= 5e-12
    Href, Zref = ref_chase_np(Ho.copy(), Zo.copy(), S, ifirst + 1, ilast)
    Href = _scrub(Href, ilast)
    sweep_rg.rg_chase(Ht, Zt, ifirst + 1, ilast, S, want_z=True)
    assert np.abs(Ht.numpy() - Href).max() <= 5e-12 * scale
    assert np.abs(Zt.numpy() - Zref).max() <= 5e-12
    assert _structure_ok(Ht.numpy(), ilast)


@pytest.mark.parametrize("p,n,S,ifirst,ilast", CASES)
def test_apply_log_reproduces_the_chase(p, n, S, ifirst, ilast):
    # kernels B0 + B's deferred order on the interleaved chase's own log
    _, _, _, Ho, Zo = _opened(p, n, S, ifirst, ilast)
    m = ifirst + 1
    Hp, Zp = torch.tensor(Ho), torch.tensor(Zo)
    log = torch.zeros((p, n, sweep_rg.LOG), dtype=torch.float64)
    sweep_rg.rg_chase_plain(Hp, Zp, m, ilast, S, want_z=True, log=log)
    Ha, Za = torch.tensor(Ho), torch.tensor(Zo)
    sweep_rg.rg_apply_log_plain(Ha, Za, log, m, ilast, want_z=True)
    scale = np.abs(Ho).max()
    assert float((Ha - Hp).abs().max()) <= 1e-13 * scale
    assert float((Za - Zp).abs().max()) <= 1e-13
    assert _structure_ok(Ha.numpy(), ilast)
    assert torch.equal(Ha[0, :, :m - 1], torch.tensor(Ho)[0, :, :m - 1])
    # the logged transforms are orthogonal
    for at in (0, 9, 18):
        M = log[:, m:ilast - 1, at:at + 9].reshape(-1, 3, 3)
        eye = torch.eye(3, dtype=torch.float64)
        assert float((M @ M.transpose(1, 2) - eye).abs().max()) <= 1e-15


def test_chase_matches_pallas_interpret():
    p, n, S, ifirst, ilast = 2, 8, (True, False), 2, 6
    _, _, _, Ho, Zo = _opened(p, n, S, ifirst, ilast)
    Hf, Zf = ff.from_f64(jnp.asarray(Ho)), ff.from_f64(jnp.asarray(Zo))
    Hk, Zk = rg_chase_sweep_ff(Hf, Zf, jnp.int32(ifirst + 1), jnp.int32(ilast), S=S,
                               want_z=True, interpret=True)
    Hj, Zj = state_from_jax_ff(Hk.hi, Hk.lo, np.swapaxes(np.asarray(Zk.hi), 1, 2),
                               np.swapaxes(np.asarray(Zk.lo), 1, 2))
    Ht, Zt = torch.tensor(Ho), torch.tensor(Zo)
    sweep_rg.rg_chase(Ht, Zt, ifirst + 1, ilast, S, want_z=True)
    assert float((Ht - Hj).abs().max()) <= 1e-12 * np.abs(Ho).max()
    assert float((Zt - Zj).abs().max()) <= 1e-12


def test_ladders_match_pallas_interpret():
    p, n, S, ifirst, ilast = 2, 8, (True, False), 1, 6
    rng = np.random.default_rng(8)
    H, Z, rot = _mk_problem(p, n, S, rng, ilast)
    H[0][ilast, ilast - 2] = 0.25            # a closing bulge
    Hf, Zf = ff.from_f64(jnp.asarray(H)), ff.from_f64(jnp.asarray(Z))
    rf = ff.from_f64(jnp.asarray(rot))
    rots = [ff.FF(rf.hi[k], rf.lo[k]) for k in range(4)]
    for mode in ("open", "close"):
        if mode == "open":
            Hk, Zk = rg_opening_ff(Hf, Zf, ifirst, ilast, *rots, S, want_z=True,
                                   interpret=True)
            j = ifirst
        else:
            Hk, Zk = rg_closing_ff(Hf, Zf, ilast - 1, ilast, S, want_z=True,
                                   interpret=True)
            j = ilast - 1
        Hj, Zj = state_from_jax_ff(Hk.hi, Hk.lo, np.swapaxes(np.asarray(Zk.hi), 1, 2),
                                   np.swapaxes(np.asarray(Zk.lo), 1, 2))
        Ht, Zt = torch.tensor(H), torch.tensor(Z)
        rgopen.rg_ladder(Ht, Zt, mode, j, ilast, torch.tensor(rot), S, want_z=True)
        assert float((Ht - Hj).abs().max()) <= 1e-12 * np.abs(H).max(), mode
        assert float((Zt - Zj).abs().max()) <= 1e-12, mode


@pytest.mark.parametrize("mode", ["open", "close", "chain"])
def test_ladder_window_bounds(mode):
    # rhi / clo (the want_t=False window) leave everything outside alone
    p, n, S = 3, 10, (True, False, True)
    H, Z, rot = _mk_problem(p, n, S, np.random.default_rng(9), 8)
    j = {"open": 3, "close": 7, "chain": 5}[mode]
    H[0][j + 2, j] = 0.3
    Hb = torch.tensor(H)
    rgopen.rg_ladder(Hb, torch.tensor(Z), mode, j, 8, torch.tensor(rot), S,
                     want_z=True, rhi=9, clo=2)
    Hu = torch.tensor(H)
    rgopen.rg_ladder(Hu, torch.tensor(Z), mode, j, 8, torch.tensor(rot), S, want_z=True)
    assert torch.equal(Hb[:, :, 9:], torch.tensor(H)[:, :, 9:])
    assert torch.equal(Hb[:, :2, :], torch.tensor(H)[:, :2, :])
    assert float((Hb[:, 2:, :9] - Hu[:, 2:, :9]).abs().max()) <= 1e-15 * np.abs(H).max()


def _blocks(rng, p, k, S):
    W = np.zeros((p, k, k))
    W[0] = rng.standard_normal((k, k))
    if k == 3:
        W[0][2, 0] = 0.0
    for l in range(1, p):
        W[l] = np.triu(rng.standard_normal((k, k))) + 2 * np.eye(k)
    return W


@pytest.mark.parametrize("S", [(True, False, True), (True, True, False, False)])
def test_2x2_machinery_matches_jax(S):
    p = len(S)
    rng = np.random.default_rng(len(S))
    for trial in range(2):
        W = _blocks(rng, p, 2, S)
        B = np.stack([W[(t + 1) % p] for t in range(p)])
        S2 = tuple(S[(t + 1) % p] for t in range(p))
        cj, sj = jpr.qzrot2x2(jnp.asarray(B), S2)
        ct, st = tpr.qzrot2x2(B.tolist(), S2)
        assert abs(float(cj) - ct) <= 1e-13 and abs(float(sj) - st) <= 1e-13
        Bj, dj = jpr.rp2x2ssr(jnp.asarray(B), S2)
        Bt, dt = tpr.rp2x2ssr(B, S2)
        assert bool(dj) == dt
        if dt:     # unsplit (complex) pairs keep rotating: compare the flag only
            assert np.abs(np.asarray(Bj) - np.array(Bt)).max() <= 1e-12 * np.abs(B).max()
        ej = [float(x) for x in jpr.eig2x2_product(jnp.asarray(W), S)]
        et = tpr.eig2x2_product(W, S)
        wj = [complex(ej[0], ej[1]) * 2.0 ** ej[4], complex(ej[2], ej[3]) * 2.0 ** ej[5]]
        wt = [complex(et[0], et[1]) * 2.0 ** et[4], complex(et[2], et[3]) * 2.0 ** et[5]]
        assert ej[6] == et[6]
        assert max(abs(a - b) for a, b in zip(wj, wt)) <= 1e-13 * max(map(abs, wj))


@pytest.mark.parametrize("exceptional", [False, True])
def test_opening_rotations_match_jax(exceptional):
    p, n, S = 4, 9, (True, False, True, False)
    rng = np.random.default_rng(12)
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for l in range(1, p):
        H[l] = np.triu(rng.standard_normal((n, n))) + 2 * np.eye(n)
    j, il = 2, 7
    key = jax.random.PRNGKey(5)
    iiter = 10 if exceptional else 3
    cj = [float(x) for x in jpr._opening_rotations(jnp.asarray(H), S, j, il, key, iiter)[:4]]
    normals = None
    if exceptional:
        normals = np.asarray(jax.random.normal(jax.random.split(key)[1], (4,), jnp.float64))
    ct = tpr.opening_rotations(H[:, j:j + 3, j:j + 3], H[:, il - 1:il + 1, il - 1:il + 1], S,
                               normals)
    assert max(abs(a - b) for a, b in zip(cj, ct)) <= 1e-13


def test_givens_host_real_branch_matches_tensor():
    rng = np.random.default_rng(13)
    vals = list(rng.standard_normal((20, 2))) + [(0.0, 2.0), (3.0, 0.0), (0.0, -1.0),
                                                 (-2.0, 1e-300)]
    for f, g in vals:
        ch, sh, rh = givens_host(float(f), float(g))
        # one-entry tensors: the tensor code (two 0-dim CPU tensors take
        # givens_host itself)
        ct, st, rt = givens_real(torch.tensor([f], dtype=torch.float64),
                                 torch.tensor([g], dtype=torch.float64))
        assert (ch, sh, rh) == (float(ct), float(st), float(rt))
        assert isinstance(sh, float)


@pytest.mark.parametrize("action", ["pos", "neg_down", "neg_up", "czshift"])
def test_deflate_cores_on_real_input(action):
    # the real float64 branch of the shared deflation actions: orthogonal,
    # the zero lands where it should, and the cycle is reproduced
    p, n, S = 4, 8, (True, True, False, True)
    rng = np.random.default_rng(14)
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for l in range(1, p):
        H[l] = np.triu(rng.standard_normal((n, n)))
    ldef, jdef = {"pos": (1, 4), "neg_down": (2, 6), "neg_up": (2, 1),
                  "czshift": (1, 3)}[action]
    if action != "czshift":
        H[ldef][jdef, jdef] = 0.0
    Ht = torch.tensor(H)
    Zt = torch.eye(n, dtype=torch.float64).expand(p, n, n).clone()
    cores = DeflateCores(p, S, True, EPS, np.finfo(np.float64).tiny * n / EPS)
    if action == "pos":
        cores.pos_core(Ht, Zt, 0, ldef, jdef, n - 1)
    elif action == "czshift":
        cores.czshift_core(Ht, Zt, 0, n - 1)
    else:
        cores.neg_core(Ht, Zt, 0, ldef, jdef, n - 1)
    T, Z = Ht.numpy(), Zt.numpy()
    assert T.dtype == np.float64
    for l in range(p):
        assert np.abs(Z[l] @ Z[l].T - np.eye(n)).max() <= 1e-14
        a, b = (l, (l + 1) % p) if S[l] else ((l + 1) % p, l)
        assert np.abs(Z[a] @ T[l] @ Z[b].T - H[l]).max() <= 1e-13 * np.abs(H).max()
    for l in range(1, p):
        assert np.all(np.tril(T[l], -1) == 0)
    if action == "pos":
        assert T[0][n - 1, n - 2] == 0 or T[0][jdef + 1, jdef] == 0
    elif action == "neg_down":
        assert T[0][n - 1, n - 2] == 0
    elif action == "neg_up":
        assert T[0][1, 0] == 0


def test_sweep_from_row_one_is_exact():
    """Regression test for the JAX f64 route's factor-0 fault, on the port's
    path (it does not reproduce the JAX mechanism).

    On the rg cell's draw (p=8, n=256, alternating S) the JAX route's 10th
    iteration, a sweep on the window [1, 255] (H[0][1, 0] deflated), comes
    out with a wrong factor 0 in some replays of the same compiled program
    from the same state (``scripts/rg_jax_replay.py``).  Here: one sweep of
    the same kind through the port's ``double_shift_sweep`` (a window from
    row 1, p=8, alternating S) keeps the backward error of every factor at
    rounding level and gives the same bits when repeated.
    """
    p, n = 8, 24
    S = tuple(l % 2 == 0 for l in range(p))
    A = np.random.default_rng(4242).standard_normal((p, n, n))
    H, Q = phessenberg_signed_core(torch.tensor(A), S)
    H[0, 1, 0] = 0.0
    A0 = np.stack([(Q[l] @ H[l] @ Q[(l + 1) % p].T if S[l] else
                    Q[(l + 1) % p] @ H[l] @ Q[l].T).numpy() for l in range(p)])
    outs = []
    for _ in range(2):
        Hs, Zs = H.clone(), Q.clone()
        tpr.double_shift_sweep(Hs, Zs, S, 1, n - 1)
        outs.append((Hs, Zs))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    T, Z = outs[0][0].numpy(), outs[0][1].numpy()
    assert not np.array_equal(T, H.numpy())
    for l in range(p):
        a, b = (l, (l + 1) % p) if S[l] else ((l + 1) % p, l)
        assert np.abs(Z[a] @ T[l] @ Z[b].T - A0[l]).max() <= 1e-13 * np.abs(A0).max()
    assert np.all(np.tril(T[0], -2) == 0) and T[0][1, 0] == 0
    assert np.all(np.diagonal(T[0], -1)[1:] != 0)     # a sweep leaves the window unreduced
