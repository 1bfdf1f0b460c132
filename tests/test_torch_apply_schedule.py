"""The schedule of the apply kernels B0 and B, as a numpy model, on the CPU.

``tests/torch_apply_host.py`` models the schedule of
``csrc/sweep.cu::sweep_left_kernel`` and ``sweep_right_kernel`` (lines in
tiles, positions in chunks staged with their log rows, all NB logs in one
pass, bulge b two steps behind bulge b-1) and replays the design before it
(one walk per bulge).  Checks, on seeded Hessenberg-triangular cycles and
logs of random orthogonal 3x3 transforms:

* the model equals the replay bit for bit (``np.array_equal``) for p in
  {1, 2, 5}, n in {7, 40}, the windows (0, n-1), (2, n-3), (k, k+1),
  (k, k+2) and (m, N-2), NB = 1..4, tiles and chunks that do and do not
  divide the lines and the span, with and without Z;
* the model against ``apply_log_plain`` (torch's matrix products round
  otherwise): 1e-13 relative, the same exact structural zeros, and column
  m-1 of H[0] at row m kept;
* with a skew of one step the result differs from the replay, and a chunk
  shorter than 2 NB steps is refused;
* B0's output is full below the (sub)diagonal although its input is zero
  there (the entries that ``chip_smoke.py::apply_bounds`` counts).

No JAX: numpy, torch's CPU build and the port only.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import sweep
from torch_apply_host import apply_model, random_logs, replay_left, replay_parent
from torch_mb_host import mk_problem
from torch_window_host import sweep_log_full


def _windows(n):
    """(0, n-1), (2, n-3), (k, k+1), (k, k+2), (m, N-2) with N = n+1."""
    return [(0, n - 1), (2, n - 3), (n // 3, n // 3 + 1), (max(1, n // 4), max(1, n // 4) + 2),
            (n // 2, n - 1)]


# (lines per tile, positions per chunk): the kernels' own, and tiles and
# chunks that do not divide the lines or the span
SIZES = [(32, 16), (5, 8), (8, 11), (3, 9)]

CASES = []
for p in (1, 2, 5):
    for n in (7, 40):
        for w, (m, i) in enumerate(_windows(n)):
            c = len(CASES)
            CASES.append((p, n, m, i, 1 + c % 4, SIZES[c % len(SIZES)], c % 2 == 0))


def _state(p, n, m, i, nb, seed):
    rng = np.random.default_rng(seed)
    H, Z, _ = mk_problem(p, n, rng)
    if m > 0:
        H[0, m, m - 1] = 0.5
    R = random_logs(rng, 4, p, n + 1, m, i)
    return H, Z, R


@pytest.mark.parametrize("p,n,m,i,nb,sizes,want_z", CASES)
def test_model_equals_parent(p, n, m, i, nb, sizes, want_z):
    H, Z, R = _state(p, n, m, i, nb, 100 * p + n + m)
    Z = Z if want_z else None
    Hp, Zp = replay_parent(H, Z, R, m, i, nb)
    Hm, Zm = apply_model(H, Z, R, m, i, nb, cols=sizes[0], rows=sizes[0], chunk=sizes[1])
    assert not np.isnan(Hp).any()
    assert np.array_equal(Hm, Hp)
    assert Zm is None if Z is None else np.array_equal(Zm, Zp)


@pytest.mark.parametrize("nb", [1, 2, 3, 4])
@pytest.mark.parametrize("want_z", [True, False])
def test_model_equals_parent_every_nb(nb, want_z):
    p, n, m, i = 2, 40, 2, 37
    H, Z, R = _state(p, n, m, i, nb, 7 + nb)
    Z = Z if want_z else None
    Hp, Zp = replay_parent(H, Z, R, m, i, nb)
    Hm, Zm = apply_model(H, Z, R, m, i, nb)
    assert np.array_equal(Hm, Hp)
    assert Zm is None if Z is None else np.array_equal(Zm, Zp)


def _plain(H, Z, R, m, i, nb):
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    Rt = torch.tensor(np.nan_to_num(np.asarray(R).reshape(-1, *H.shape[:2], 9)))
    sweep.apply_log_plain(Ht, Zt, Rt, m, i, want_z=True, nb=nb)
    return Ht.numpy(), Zt.numpy()


# (p, n, m, i, nb); the last two replay kernel A's own log (model of
# tests/torch_window_host.py) instead of random transforms
PLAIN_CASES = [(1, 40, 0, 39, 1), (2, 40, 3, 37, 2), (5, 40, 20, 39, 4), (5, 7, 2, 4, 3),
               (2, 7, 3, 4, 4), (2, 40, 0, 39, None), (3, 40, 5, 38, None)]


@pytest.mark.parametrize("p,n,m,i,nb", PLAIN_CASES)
def test_model_matches_apply_log_plain(p, n, m, i, nb):
    H, Z, R = _state(p, n, m, i, nb, 31 * p + n)
    if nb is None:  # kernel A's log of the sweep over [m, i]
        nb = 1
        H[0, i + 1, i] = 0.0
        v0 = np.random.default_rng(n).standard_normal(3)
        R, _ = sweep_log_full(H, m, i, list(v0 / np.abs(v0).sum()))
        R = np.where(np.arange(n + 1)[None, :, None] >= m, R, np.nan)
    Hm, Zm = apply_model(H, Z, R, m, i, nb)
    Ha, Za = _plain(H, Z, R, m, i, nb)
    assert np.array_equal(Hm, replay_parent(H, Z, R, m, i, nb)[0])
    assert np.abs(Hm - Ha).max() <= 1e-13 * np.abs(H).max()
    assert np.abs(Zm - Za).max() <= 1e-13
    assert np.array_equal(Hm == 0.0, Ha == 0.0)  # the same exact zeros
    if m > 0:
        assert Hm[0, m, m - 1] == H[0, m, m - 1]  # the window-boundary column kept
    for r in range(m + 1, i + 1):
        assert not Hm[0, r, max(m - 1, 0):r - 1].any() and not Hm[1:, r, m:r].any()


def test_skew_of_one_step_differs():
    p, n, m, i, nb = 2, 40, 0, 39, 2
    H, Z, R = _state(p, n, m, i, nb, 3)
    Hp, Zp = replay_parent(H, Z, R, m, i, nb)
    Hm, Zm = apply_model(H, Z, R, m, i, nb, skew=1)
    assert not np.array_equal(Hm, Hp) and not np.array_equal(Zm, Zp)


def test_chunk_shorter_than_the_skewed_bulges_is_refused():
    p, n, m, i, nb = 2, 40, 0, 39, 4
    H, Z, R = _state(p, n, m, i, nb, 4)
    with pytest.raises(AssertionError):
        apply_model(H, Z, R, m, i, nb, chunk=2 * nb - 1)


@pytest.mark.parametrize("p,n,m,i", [(3, 40, 0, 39), (2, 40, 5, 30)])
def test_left_transforms_fill_below_the_band(p, n, m, i):
    """On kernel A's log the chained left transforms of B0 fill every entry
    of rows m..i below the (sub)diagonal, where B0's input is zero, so B0
    cannot stop at a band of rows, B reads full rows, and only B writes the
    zeros back; row i+1 and column m-1 below row m come out as they went in."""
    H, _, _ = _state(p, n, m, i, 1, 11 * p + m)
    H[0, i + 1, i] = 0.0
    if m > 0:
        H[0, m, m - 1] = 0.0
    v0 = np.random.default_rng(n + m).standard_normal(3)
    R, _ = sweep_log_full(H, m, i, list(v0 / np.abs(v0).sum()))
    Hl = replay_left(H, R, m, i, 1)
    for f in range(p):
        d = 2 if f == 0 else 1  # the first row below the (sub)diagonal
        for c in range(m, i):
            assert not H[f, c + d:i + 2, c].any()
            assert np.all(Hl[f, c + d:i + 1, c] != 0.0), (f, c)
    assert np.array_equal(Hl[:, i + 1], H[:, i + 1])
    if m > 0:
        assert np.array_equal(Hl[:, m + 1:, m - 1], H[:, m + 1:, m - 1])
