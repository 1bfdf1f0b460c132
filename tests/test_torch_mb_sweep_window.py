"""Kernel A-mb's look-ahead window schedule, as a numpy model, on the CPU.

``tests/torch_mb_window_host.py`` models the batched schedule of
``csrc/sweep.cu::sweep_generate_mb_kernel`` (blocks of L ticks on small
per-factor windows that reach (nb-1) gap rows and columns above the
leading bulge, the left transforms right of the window deferred to the
batch's end) and the order before it on a full working copy.  Checks, on
seeded cycles whose triangular factors have diagonals of modulus in
[1, 2), at p in {1, 2, 3, 5}, nb in {2, 3, 4} with fewer active bulges
than configured, gap in {3, 5}, odd n, m > 0, windows shorter than
(nbact-1) gap and L in {1, 2, 7}:

* the batched logs equal the full-copy logs bit for bit, and so does the
  last batch's window on every entry it holds: the schedule reorders no
  operation on any entry;
* both against ``chase_sweep_mb_plain(..., log=)``: max(1e-13, 10 sens),
  sens the plain version's own change under a relative 1e-16 perturbation
  of H (the plain version applies the 3- and 2-reflectors one after the
  other, the model their fused 3x3, and torch's CPU sqrt is not always
  correctly rounded; the generation chains amplify that, the trailing
  bulges' more, as their random shifts lie off the spectrum: sens reaches
  3e-13 here);
* the model's logs applied by ``apply_log_plain`` against the plain
  sweep's H: max(1e-13, 10 sens) max|H|, sens as above on H;
* a window that carries one row too few for the columns right of it
  shows as NaN in the log, and reads outside a block's extents fail.

No JAX: the file imports numpy, torch and the port only.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import sweep
from torch_mb_window_host import _Window, sweep_log_mb_full, sweep_log_mb_windowed


def _problem(p, n, nb, seed):
    rng = np.random.default_rng(seed)
    N = n + 1
    H = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
        d = np.diagonal(H[f])[:n]
        np.fill_diagonal(H[f, :n, :n], np.where(d >= 0, 1.0, -1.0) * (1.0 + rng.random(n)))
    v0 = rng.standard_normal(3)
    sig = [tuple(0.5 * rng.standard_normal(3)) for _ in range(nb)]
    return H, v0 / np.abs(v0).sum(), sig


def _plain(H, m, i, v0, sig, nb, gap, nbact):
    """The plain sweep's H and its logs of the active bulges on [m, i)."""
    p, N, _ = H.shape
    Ht = torch.tensor(H)
    R = torch.zeros((nb, p, N, 9), dtype=torch.float64)
    sweep.chase_sweep_mb_plain(Ht, None, m, i, v0, sig, nbact, nb=nb, gap=gap, want_z=False,
                               log=R)
    return Ht, R.numpy()[:nbact, :, m:i]


# (p, n, m, i, nb, nbact, gap, L)
CASES = [
    (1, 13, 0, 12, 2, 2, 3, 2),    # p = 1: the band update lands on factor 0
    (1, 21, 0, 20, 4, 4, 3, 7),
    (1, 11, 2, 7, 4, 4, 5, 7),     # 5 steps < (nbact-1) gap = 15
    (2, 15, 0, 14, 3, 3, 3, 7),
    (2, 21, 3, 20, 3, 3, 5, 2),
    (2, 16, 1, 15, 4, 2, 5, 1),    # nbact < nb: lowext still (nb-1) gap
    (3, 14, 2, 12, 4, 4, 3, 1),
    (3, 12, 4, 8, 4, 4, 3, 2),     # 4 steps < 9
    (3, 19, 0, 18, 2, 2, 5, 1),
    (5, 17, 1, 16, 4, 3, 3, 2),
    (5, 9, 0, 8, 2, 1, 3, 1),      # one active bulge of two
    (5, 13, 3, 12, 3, 2, 3, 7),
    (3, 9, 5, 6, 3, 3, 3, 2),      # the closing step alone, three bulges
]


@pytest.mark.parametrize("p,n,m,i,nb,nbact,gap,L", CASES)
def test_mb_window_model_matches_full_and_plain(p, n, m, i, nb, nbact, gap, L):
    H, v0, sig = _problem(p, n, nb, 1000 * p + 10 * n + L + gap)
    if m > 0:
        H[0, m, m - 1] = 0.0
    H[0, i + 1, i] = 0.0
    Rf, Cf = sweep_log_mb_full(H, m, i, v0, sig, nb, gap, nbact)
    Rw, W, base = sweep_log_mb_windowed(H, m, i, v0, sig, nb, gap, nbact, L)
    assert np.array_equal(Rw[:nbact, :, m:i], Rf[:nbact, :, m:i])
    assert not np.isnan(Rw[:nbact, :, m:i]).any()
    # the last batch's window against the full copy, entry by entry
    held = ~np.isnan(W)
    S = W.shape[1]
    ref = np.full_like(W, np.nan)
    r0, c0 = max(base, 0), max(base - 1, 0)
    r1, c1 = min(base + S, i + 2), min(base - 1 + S, i + 2)
    ref[:, r0 - base:r1 - base, c0 - base + 1:c1 - base + 1] = Cf[:, r0:r1, c0:c1]
    assert held.any() and np.array_equal(W[held], ref[held])

    Ht, Rp = _plain(H, m, i, v0, sig, nb, gap, nbact)
    pert = 1.0 + 1e-16 * np.random.default_rng(1).standard_normal(H.shape)
    Hq, Rq = _plain(H * pert, m, i, v0, sig, nb, gap, nbact)
    assert np.abs(Rw[:nbact, :, m:i] - Rp).max() <= max(1e-13, 10 * np.abs(Rq - Rp).max())

    Ha = torch.tensor(H)
    sweep.apply_log_plain(Ha, None, torch.tensor(np.nan_to_num(Rw)), m, i, want_z=False,
                          nb=nbact)
    scale = np.abs(H).max()
    tol = max(1e-13, 10 * float((Hq - Ht).abs().max()) / scale)
    assert float((Ha - Ht).abs().max()) <= tol * scale


def test_mb_window_short_carry_shows_as_nan():
    # the columns right of a block carry lowext + 2 rows; one fewer loses a
    # row the trailing bulge still reads, which reaches the log as NaN
    p, n, m, i, nb, gap, L = 2, 24, 0, 23, 3, 3, 2
    H, v0, sig = _problem(p, n, nb, 5)
    Rw, _, _ = sweep_log_mb_windowed(H, m, i, v0, sig, nb, gap, nb, L)
    assert not np.isnan(Rw[:, :, m:i]).any()
    Rs, _, _ = sweep_log_mb_windowed(H, m, i, v0, sig, nb, gap, nb, L,
                                     carry_rows=(nb - 1) * gap + 1)
    assert np.isnan(Rs[:, :, m:i]).any()


def test_mb_window_extents_are_enforced():
    # a block holds rows T..kk0+L+2 and columns T-1..kk0+L+1 only
    win = _Window(2, 3 + 6 + 3)
    win.place(10 - 6, 4, 10 + 3 + 2, 10 + 3 + 1)
    win.get(0, 4, 3)      # row T, column T-1: inside
    win.get(1, 15, 14)    # row kk0+L+2, column kk0+L+1: inside
    with pytest.raises(AssertionError):
        win.get(0, 3, 5)  # row T-1: outside
    with pytest.raises(AssertionError):
        win.get(0, 5, 15)  # column kk0+L+2: outside


def test_sweep_generate_mb_on_the_cpu_is_the_plain_log():
    # the wrapper on a CPU stack: chase_sweep_mb_plain's logs of the active
    # bulges, H unchanged
    p, n, m, i, nb, nbact, gap = 3, 14, 1, 12, 3, 2, 3
    H, v0, sig = _problem(p, n, nb, 9)
    Ht = torch.tensor(H)
    R = sweep.sweep_generate_mb(Ht, m, i, v0, sig, nbact, nb=nb, gap=gap)
    assert torch.equal(Ht, torch.tensor(H)) and tuple(R.shape) == (nbact, p, n + 1, 9)
    _, Rp = _plain(H, m, i, v0, sig, nb, gap, nbact)
    assert np.array_equal(R.numpy()[:, :, m:i], Rp)
