"""Kernel A's look-ahead window schedule, as a numpy model, on the CPU.

``tests/torch_window_host.py`` models the batched schedule of
``csrc/sweep.cu::sweep_generate_kernel`` (blocks of L steps on small
per-factor windows, the left transforms right of the window deferred to
the batch's end) and the reference order on a full working copy.  Checks,
on seeded cycles whose triangular factors have diagonals of modulus in
[1, 2):

* the batched log equals the full-copy log bit for bit, and so does the
  last batch's window on every entry it holds: the schedule reorders no
  operation on any entry;
* the model's log against ``chase_sweep_plain(..., log=)``: the two round
  differently (the plain version applies the 3- and 2-reflectors one after
  the other, the model their fused 3x3; torch's CPU sqrt is not always
  correctly rounded), and the chain of generations amplifies that, so the
  tolerance is max(1e-15, 10 sens) relative to max|R|, sens being the plain
  version's own change under a relative 1e-16 perturbation of H;
* the model's log applied by ``apply_log_plain`` against the plain sweep's
  H: 1e-13 max|H| (the tolerance of tests/test_torch_sweep.py's replay).

No JAX: the file imports numpy, torch and the port only.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import sweep
from torch_window_host import sweep_log_full, sweep_log_windowed


def _problem(p, n, seed):
    rng = np.random.default_rng(seed)
    N = n + 1
    H = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
        d = np.diagonal(H[f])[:n]
        np.fill_diagonal(H[f, :n, :n], np.where(d >= 0, 1.0, -1.0) * (1.0 + rng.random(n)))
    v0 = rng.standard_normal(3)
    return H, v0 / np.abs(v0).sum()


def _plain(H, m, i, v0, early):
    Ht = torch.tensor(H)
    R = torch.zeros((H.shape[0], H.shape[1], 9), dtype=torch.float64)
    sweep.chase_sweep_plain(Ht, None, m, i, v0, want_z=False, early=early, log=R)
    return Ht.numpy(), R.numpy()


# (p, n, m, i, L, early): windows of i - m steps shorter than L, equal to
# L and not a multiple of it; m > 0; every sweep ends with the closing
# 2-reflector step at k = i-1
CASES = [
    (1, 10, 0, 9, 3, False),    # 9 steps, 3 batches of 3
    (1, 8, 2, 6, 5, False),     # 4 steps < L
    (2, 12, 0, 11, 5, False),   # 11 steps: 5 + 5 + 1
    (2, 8, 1, 6, 5, False),     # 5 steps == L
    (2, 6, 2, 3, 2, False),     # the closing step alone
    (3, 9, 1, 7, 2, False),
    (3, 10, 3, 9, 1, True),     # L = 1, early start
    (3, 8, 2, 4, 5, False),     # 2 steps < L
    (16, 14, 0, 13, 5, False),  # 13 steps: 5 + 5 + 3
    (16, 12, 3, 11, 1, False),
    (16, 10, 2, 8, 3, True),    # 6 steps == 2 L, early start
]


@pytest.mark.parametrize("p,n,m,i,L,early", CASES)
def test_window_model_matches_plain_log(p, n, m, i, L, early):
    H, v0 = _problem(p, n, 1000 * p + 10 * n + L)
    if m > 0:
        H[0, m, m - 1] = 1e-3 if early else 0.0
    H[0, i + 1, i] = 0.0
    Rf, Cf = sweep_log_full(H, m, i, list(v0))
    Rw, W, k0 = sweep_log_windowed(H, m, i, list(v0), L)
    assert np.array_equal(Rw[:, m:i], Rf[:, m:i])
    assert not np.isnan(Rw[:, m:i]).any()
    # the last batch's window against the full copy, entry by entry
    rows, cols = W.shape[1], W.shape[2]
    held = ~np.isnan(W)
    ref = np.full_like(W, np.nan)
    r1, c1 = min(k0 + rows, i + 2), min(k0 - 1 + cols, i + 2)
    ref[:, :r1 - k0, :c1 - k0 + 1] = Cf[:, k0:r1, k0 - 1:c1]
    assert held[:, :r1 - k0, 1:c1 - k0 + 1].all()
    assert np.array_equal(W[held], ref[held])

    Hp, Rp = _plain(H, m, i, v0, early)
    pert = 1.0 + 1e-16 * np.random.default_rng(1).standard_normal(H.shape)
    _, Rq = _plain(H * pert, m, i, v0, early)
    sens = np.abs(Rq[:, m:i] - Rp[:, m:i]).max()
    scale = np.abs(Rp[:, m:i]).max()
    assert np.abs(Rw[:, m:i] - Rp[:, m:i]).max() <= max(1e-15, 10 * sens) * scale

    Ha = torch.tensor(H)
    Rt = torch.tensor(np.nan_to_num(Rw))
    sweep.apply_log_plain(Ha, None, Rt, m, i, want_z=False)
    if early:  # what chase_sweep does on the card: R[0, m, 0] is 1 - tau
        Ha[0, m, m - 1] *= Rt[0, m, 0]
    assert float(np.abs(Ha.numpy() - Hp).max()) <= 1e-13 * np.abs(H).max()


def test_window_extents_are_enforced():
    # a block holds rows k0..k0+L+2 and columns k0-1..k0+L+1 only: a model
    # that reads one column further fails its index assert
    import torch_window_host as wh
    H, v0 = _problem(2, 8, 7)
    win = wh._Window(2, 3, 7)
    win.k0 = 2
    win.get(0, 2 + 5, 1)  # row k0+L+2, column k0-1: inside
    with pytest.raises(AssertionError):
        win.get(0, 2, 2 + 5)  # column k0+L+2: outside
    with pytest.raises(AssertionError):
        win.get(0, 1, 2)  # row k0-1: outside
