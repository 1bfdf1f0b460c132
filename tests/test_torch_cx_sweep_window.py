"""The complex kernel A's look-ahead window schedule, as a numpy model, on
the CPU.

``tests/torch_cx_window_host.py`` models the batched schedule of
``csrc/sweep_cx.cu::qz_generate_kernel`` (blocks of L steps on small
per-factor windows, the left rotations right of the window deferred to the
batch's end) and the reference order on a full working copy.  Checks, on
seeded complex cycles whose triangular factors have diagonals of modulus
in [1, 2), for alternating, all-direct and all-inverse (but S[0])
signatures:

* the batched log equals the full-copy log bit for bit, and so does the
  last batch's window on every entry it holds: the schedule reorders no
  operation on any entry;
* the model's log against ``qz_sweep_plain(..., log=)``: the two round
  differently (the plain version rotates rows and columns by torch matrix
  products), and the chain of generations amplifies that, so the tolerance
  is max(1e-15, 10 sens) relative to max|log|, sens being the plain
  version's own change under a relative 1e-16 perturbation of H;
* the model's log replayed by ``qz_apply_log_plain`` against the plain
  sweep's H: 1e-13 max|H| (the tolerance of tests/test_torch_cx_sweep.py's
  replay).

No JAX: the file imports numpy, torch and the port only.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import sweep_cx
from torch_cx_window_host import LOG, qz_log_full, qz_log_windowed


def _problem(p, n, seed):
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    H = np.zeros((p, n, n), complex)
    H[0] = np.triu(cplx(n, n), -1)
    for f in range(1, p):
        H[f] = np.triu(cplx(n, n))
        d = cplx(n)
        np.fill_diagonal(H[f], d / np.abs(d) * (1.0 + rng.random(n)))
    f, g = cplx(2)
    d = np.hypot(abs(f), abs(g))
    return H, np.array([abs(f) / d, (f / abs(f)) * np.conj(g) / d])


def _sig(kind, p):
    if kind == "alt":
        return tuple(l % 2 == 0 for l in range(p))
    return tuple(l == 0 or kind == "direct" for l in range(p))


def _plain_log(H, m, i, cs, S):
    Ht = torch.tensor(H)
    log = torch.zeros((H.shape[0], H.shape[1], LOG), dtype=torch.complex128)
    sweep_cx.qz_sweep_plain(Ht, None, m, i, torch.tensor(cs), S, want_z=False, log=log)
    return Ht.numpy(), log.numpy()


def _written(log, m, i):
    """Every entry kernel A writes: L, R, ZR of each factor, r of factor 0."""
    return np.concatenate([log[:, m:i, :12].ravel(), log[0, m:i, 12]])


# (p, n, m, i, L, S): windows of i - m steps shorter than L, equal to L and
# not a multiple of it; m > 0; a window that ends at n-1 (the ring close
# cut at the last row) and ones that end above it
CASES = [
    (1, 10, 0, 9, 2, "direct"),   # p = 1: 9 steps, 5 batches, ends at n-1
    (1, 8, 2, 5, 5, "direct"),    # 3 steps < L
    (2, 12, 0, 11, 5, "alt"),     # 11 steps: 5 + 5 + 1
    (2, 9, 1, 6, 5, "inverse"),   # 5 steps == L
    (2, 6, 2, 3, 2, "alt"),       # one step
    (3, 9, 1, 7, 2, "alt"),
    (3, 10, 3, 9, 1, "inverse"),  # L = 1, ends at n-1
    (3, 8, 2, 4, 5, "direct"),    # 2 steps < L
    (16, 14, 0, 13, 5, "alt"),    # 13 steps: 5 + 5 + 3
    (16, 12, 3, 10, 1, "direct"),
    (16, 10, 2, 8, 2, "inverse"),  # 6 steps == 3 L
]


@pytest.mark.parametrize("p,n,m,i,L,kind", CASES)
def test_cx_window_model_matches_plain_log(p, n, m, i, L, kind):
    S = _sig(kind, p)
    H, cs = _problem(p, n, 1000 * p + 10 * n + L)
    if m > 0:
        H[0, m, m - 1] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    Lf, Cf = qz_log_full(H, m, i, cs, S)
    Lw, W, k0 = qz_log_windowed(H, m, i, cs, S, L)
    assert np.array_equal(_written(Lw, m, i), _written(Lf, m, i))
    assert not np.isnan(_written(Lw, m, i)).any()
    # the last batch's window against the full copy, entry by entry
    held = ~np.isnan(W)
    r1, c1 = min(k0 + W.shape[1], i + 2, n), min(k0 - 1 + W.shape[2], i + 1)
    ref = np.full_like(W, np.nan)
    ref[:, :r1 - k0, :c1 - k0 + 1] = Cf[:, k0:r1, k0 - 1:c1]
    assert held[:, :r1 - k0, 1:c1 - k0 + 1].all()
    assert np.array_equal(W[held], ref[held])

    Hp, Lp = _plain_log(H, m, i, cs, S)
    pert = 1.0 + 1e-16 * np.random.default_rng(1).standard_normal(H.shape)
    _, Lq = _plain_log(H * pert, m, i, cs, S)
    wp, wq, ww = _written(Lp, m, i), _written(Lq, m, i), _written(Lw, m, i)
    sens = np.abs(wq - wp).max()
    assert np.abs(ww - wp).max() <= max(1e-15, 10 * sens) * np.abs(wp).max()

    Ha = torch.tensor(H)
    sweep_cx.qz_apply_log_plain(Ha, None, torch.tensor(np.nan_to_num(Lw)), m, i, want_z=False)
    assert float(np.abs(Ha.numpy() - Hp).max()) <= 1e-13 * np.abs(H).max()


def test_cx_window_extents_are_enforced():
    # a block holds rows k0..k0+L+1 and columns k0-1..k0+L only: a model
    # that reads one column or row further fails its index assert
    import torch_cx_window_host as wh
    win = wh._Window(2, 3, 12, 9)
    win.k0 = 2
    win.get(0, 2 + 4, 1)  # row k0+L+1, column k0-1: inside
    with pytest.raises(AssertionError):
        win.get(0, 2, 2 + 4)  # column k0+L+1: outside
    with pytest.raises(AssertionError):
        win.get(0, 2 + 5, 2)  # row k0+L+2: outside
    with pytest.raises(AssertionError):
        win.get(0, 1, 2)  # row k0-1: outside
    win.k0 = 7
    with pytest.raises(AssertionError):
        win.get(0, 8, 10)  # column i+1: outside, though inside k0+L


def test_qz_sweep_generate_on_the_cpu_is_the_plain_log():
    # the kernel A wrapper on a CPU tensor: qz_sweep_plain's log, H unchanged
    S = _sig("alt", 3)
    H, cs = _problem(3, 9, 5)
    H[0, 8, 7] = 0.0
    Ht = torch.tensor(H)
    log = sweep_cx.qz_sweep_generate(Ht, 1, 7, torch.tensor(cs), S)
    assert torch.equal(Ht, torch.tensor(H))
    _, Lp = _plain_log(H, 1, 7, cs, S)
    assert np.array_equal(log.numpy(), Lp)

