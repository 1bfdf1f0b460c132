"""The schedule of the ladder kernels D and R, as a numpy model, on the CPU.

``tests/torch_ladder_host.py`` models ``csrc/deflate.cu`` (the 2x2
deflation, kernel D) and ``csrc/rgopen.cu`` (the real generalized rotation
ladders, kernel R) in two schedules: the parent's (every 2-row or 2-column
update over whole rows or columns, in the chain's order) and the kernels'
(the chain of generations on each factor's diagonal window, the lines
outside the windows taking the logged rotations afterwards).  Checks, on
seeded Hessenberg-triangular cycles:

* the two schedules agree bit for bit (``np.array_equal``), on H and on Z,
  and H without Z is the same H: D on chainA, chainB, chainB with a
  negligible trailing diagonal, a replacement loop of several rounds, the
  20-round cap, p = 1 (the ``tgt = 0`` path), p = 2, i = 1 and i = n-1; R
  in its open, close and chain modes with alternating, all-direct and
  all-inverse (but S[0]) signatures, with and without ``rhi``/``clo``
  (``rhi`` inside the window, ``clo`` past j), at j = 0 and at the last
  legal j, p = 2;
* both against the plain torch versions ``deflate2x2_plain`` and
  ``rg_ladder_plain`` (which round otherwise): 1e-13 relative to max|H|,
  1e-13 on Z, the same exact zeros;
* a line that reaches into a window is refused.

No JAX: numpy, torch's CPU build and the port only.
"""
import numpy as np
import pytest
import torch

import torch_ladder_host as lh
from periodicschurdecompositions_jl_torch.ops import deflate, pqr_real, rgopen


def _cycle(p, n, seed, ghost):
    """Hessenberg H[0], upper triangular H[1:] with diagonals of modulus in
    [1, 2), orthogonal Z; ghost-padded to n+1 when ``ghost``."""
    rng = np.random.default_rng(seed)
    N = n + 1 if ghost else n
    H = np.zeros((p, N, N))
    Z = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
        d = rng.standard_normal(n)
        np.fill_diagonal(H[f, :n, :n], np.where(d >= 0, 1.0, -1.0) * (1.0 + rng.random(n)))
    for f in range(p):
        Z[f, :n, :n] = np.linalg.qr(rng.standard_normal((n, n)))[0]
    if ghost:   # the ghost row and column carry values too (the kernel must keep them)
        H[:, n, :] = rng.standard_normal((p, N))
        Z[:, n, :] = rng.standard_normal((p, N))
    return H, Z, rng


# ---------------------------------------------------------------- kernel D

def _defl_scalars(H, i):
    p, N, _ = H.shape
    n = N - 1
    ulp = float(np.finfo(np.float64).eps)
    smlnum = float(np.finfo(np.float64).tiny) * (n / ulp)
    hnorms = ulp * n * np.abs(H[:, :n, :n]).sum(axis=1).max(axis=1)
    D = np.stack([np.diagonal(H[f])[:n] for f in range(p)])
    U = np.stack([np.concatenate([np.diagonal(H[f], 1)[:n - 1], [0.0]]) for f in range(p)])
    S0 = np.concatenate([[0.0], np.diagonal(H[0], -1)[:n - 1]])
    sc = pqr_real.defl2_scalars(D, U, S0, i, p, hnorms, ulp, smlnum)
    return [sc[k] for k in ("jmin", "jmax", "cs0", "sn0", "replace0", "finzero", "thr")]


def _d_case(name):
    """(H, Z, args, rounds expected or None) of a named case."""
    p, n, i = {"p1": (1, 12, 6), "p2": (2, 14, 9), "i1": (4, 16, 1), "ilast": (4, 16, 15),
               "p16": (16, 24, 13)}.get(name, (5, 20, 11))
    H, Z, rng = _cycle(p, n, 17 * p + n + len(name), ghost=True)
    H[0, i + 1, i] = 0.0
    if name == "chainA":
        H[p - 1, i - 1, i - 1] = 1e-30
    elif name == "chainB-jmax":
        H[2, i, i] = 1e-30
    args = _defl_scalars(H, i)
    rounds = None
    if name in ("rounds", "cap", "p1", "p2", "i1", "ilast", "p16"):
        # the host's scalars with a replacement from the first round on
        jmin, jmax, cs0, sn0, _, finzero, thr = args
        a = rng.standard_normal(2)
        cs0, sn0 = abs(a[0]) / np.hypot(*a), np.sign(a[0]) * a[1] / np.hypot(*a)
        if name == "cap":
            thr, rounds = 0.0, 20       # never converges: the 20-round cap
        elif name == "rounds":
            thr, rounds = _thr_for(H, i, jmax, cs0, sn0, 4), 4
        args = [jmin, jmax, cs0, sn0, name != "p16", name in ("rounds", "p1"), thr]
    return H, Z, [i] + list(args), rounds


def _thr_for(H, i, jmax, cs0, sn0, rounds):
    """A threshold at which chainB (replacing from the first round on)
    stops after ``rounds`` rounds: a round with a replacement is the same
    round whatever came before, so one-round runs of the parent model give
    |H[0][i, i-1]| after each."""
    Hx, seq = np.array(H), []
    for _ in range(rounds):
        Hx = lh.deflate_parent(Hx, None, i, -1, jmax, cs0, sn0, True, False, np.inf)[0]
        seq.append(abs(Hx[0, i, i - 1]))
    above, last = min(seq[:-1]), seq[-1]
    assert above > last, seq
    return 0.5 * (above + last)


D_CASES = ["chainA", "chainB", "chainB-jmax", "rounds", "cap", "p1", "p2", "i1", "ilast",
           "p16"]


@pytest.mark.parametrize("want_z", [True, False])
@pytest.mark.parametrize("name", D_CASES)
def test_deflate_model_equals_parent(name, want_z):
    H, Z, args, rounds = _d_case(name)
    Z = Z if want_z else None
    Hp, Zp, rp = lh.deflate_parent(H, Z, *args)
    Hm, Zm, rm = lh.deflate_model(H, Z, *args)
    assert rp == rm and (rounds is None or rm == rounds)
    if name == "chainA":
        assert args[1] >= 1
    elif name in ("chainB", "chainB-jmax"):
        assert args[1] < 1 and (args[2] >= 1) == (name == "chainB-jmax")
    assert np.array_equal(Hm, Hp)
    assert Zm is None if Z is None else np.array_equal(Zm, Zp)
    if want_z:
        assert np.array_equal(lh.deflate_model(H, None, *args)[0], Hm)


@pytest.mark.parametrize("name", D_CASES)
def test_deflate_model_matches_plain(name):
    H, Z, args, _ = _d_case(name)
    Hm, Zm, _ = lh.deflate_model(H, Z, *args)
    i, jmin, jmax, cs0, sn0, replace0, finzero, thr = args
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    deflate.deflate2x2_plain(Ht, Zt, i, jmin, jmax, cs0, sn0, replace0, finzero, thr,
                             want_z=True)
    Ht, Zt = Ht.numpy(), Zt.numpy()
    assert np.abs(Hm - Ht).max() <= 1e-13 * np.abs(H).max()
    assert np.abs(Zm - Zt).max() <= 1e-13 * max(1.0, np.abs(Z).max())
    assert np.array_equal(Hm == 0.0, Ht == 0.0)


def test_deflate_line_into_the_window_is_refused(monkeypatch):
    H, Z, args, _ = _d_case("chainB")
    i = args[0]
    real = lh.deflate_lines

    def lines(p, N, i_, want_z):  # the row strip from column i: into the window
        return [(0, f, i) for f in range(p)] + real(p, N, i_, want_z)
    monkeypatch.setattr(lh, "deflate_lines", lines)
    with pytest.raises(AssertionError, match="reaches into the window"):
        lh.deflate_model(H, Z, *args)


# ---------------------------------------------------------------- kernel R

def _sig(kind, p):
    return {"alt": tuple(l % 2 == 0 for l in range(p)), "direct": (True,) * p,
            "inverse": (True,) + (False,) * (p - 1)}[kind]


def _r_state(p, n, seed):
    H, Z, rng = _cycle(p, n, seed, ghost=False)
    a, b = rng.standard_normal(2), rng.standard_normal(2)
    rot = np.array([abs(a[0]), np.sign(a[0]) * a[1], abs(b[0]), np.sign(b[0]) * b[1]])
    rot[:2] /= np.hypot(*a)
    rot[2:] /= np.hypot(*b)
    return H, Z, rot


def _r_bounds(kind, mode, j, n):
    K = 3 if mode == "open" else 2
    return {"none": {}, "window": {"rhi": min(n, j + K + 4), "clo": max(j - 3, 0)},
            "rhi_in": {"rhi": j + K - 1, "clo": max(j - 2, 0)},
            "clo_past": {"rhi": n, "clo": j + 1}}[kind]


R_CASES = []
for _p, _n in ((4, 13), (2, 10), (8, 16)):
    for _mode, _js in (("open", (0, 4, _n - 3)), ("close", (1, 5, _n - 2)),
                       ("chain", (0, 6, _n - 2))):
        for _k, _j in enumerate(_js):
            for _s in ("alt", "direct", "inverse"):
                _b = ("none", "window", "rhi_in", "clo_past")[(_k + len(R_CASES)) % 4]
                R_CASES.append((_p, _n, _mode, _j, _s, _b))


@pytest.mark.parametrize("p,n,mode,j,sig,bounds", R_CASES)
def test_rg_model_equals_parent(p, n, mode, j, sig, bounds):
    H, Z, rot = _r_state(p, n, 7 * p + n + j)
    S = _sig(sig, p)
    ilast = n - 1 if mode != "open" or j % 2 == 0 else min(n - 1, j + 5)
    if mode == "close":
        H[0, j + 1, j - 1] = 0.5    # the closing bulge the close mode consumes
    bd = _r_bounds(bounds, mode, j, n)
    Hp, Zp = lh.rg_parent(H, Z, mode, j, ilast, rot, S, **bd)
    Hm, Zm = lh.rg_model(H, Z, mode, j, ilast, rot, S, **bd)
    assert np.array_equal(Hm, Hp)
    assert np.array_equal(Zm, Zp)
    assert np.array_equal(lh.rg_model(H, None, mode, j, ilast, rot, S, **bd)[0], Hm)
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    rgopen.rg_ladder_plain(Ht, Zt, mode, j, ilast, torch.tensor(rot), S, want_z=True, **bd)
    Ht, Zt = Ht.numpy(), Zt.numpy()
    assert np.abs(Hm - Ht).max() <= 1e-13 * np.abs(H).max()
    assert np.abs(Zm - Zt).max() <= 1e-13
    assert np.array_equal(Hm == 0.0, Ht == 0.0)


def test_rg_line_into_the_window_is_refused(monkeypatch):
    H, Z, rot = _r_state(4, 13, 3)
    real = lh.rg_lines

    def lines(p, n, mode, j, ilast, rhi, clo, want_z):   # H[1]'s column strip from row j
        return [(1, 1, j)] + real(p, n, mode, j, ilast, rhi, clo, want_z)
    monkeypatch.setattr(lh, "rg_lines", lines)
    with pytest.raises(AssertionError, match="reaches into the window"):
        lh.rg_model(H, Z, "open", 4, 12, rot, _sig("alt", 4))
