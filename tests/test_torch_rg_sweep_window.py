"""Kernel rg A's look-ahead window schedule, as a numpy model, on the CPU.

``tests/torch_rg_window_host.py`` models the batched schedule of
``csrc/sweep_rg.cu::rg_generate_kernel`` (blocks of L steps on small
per-factor windows, the left rotations right of the window deferred to the
batch's end) and the reference order on a full working copy.  Checks, on
seeded real cycles whose triangular factors have diagonals of modulus in
[1, 2), after the sweep's opening ladder, for alternating, all-direct and
all-inverse (but S[0]) signatures:

* the batched log equals the full-copy log bit for bit, and so does the
  last batch's window on every entry it holds: the schedule reorders no
  operation on any entry;
* the model's log against ``rg_chase_plain(..., log=)``: the two round
  differently (the plain version rotates rows and columns by torch matrix
  products), and the chain of generations amplifies that, so the tolerance
  is max(1e-15, 10 sens) relative to max|log|, sens being the plain
  version's own change under a relative 1e-16 perturbation of H;
* the model's log replayed by ``rg_apply_log_plain`` against the plain
  chase's H: 1e-13 max|H| (the tolerance of tests/test_torch_rg_sweep.py's
  replay).

``tests/test_torch_rg_sweep.py::test_chase_matches_pallas_interpret`` holds
``rg_chase_plain`` against the JAX kernel in interpret mode, which closes
the chain model -> plain -> JAX.  No JAX here: the file imports numpy,
torch and the port only.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import rgopen, sweep_rg
from torch_rg_window_host import LOG, rg_log_full, rg_log_windowed


def _opened(p, n, m, i, S, seed):
    """A Hessenberg-triangular cycle with the window [m, i]'s boundaries
    deflated, after the opening ladder (the state kernel rg A reads)."""
    rng = np.random.default_rng(seed)
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f] = np.triu(rng.standard_normal((n, n)))
        d = rng.standard_normal(n)
        np.fill_diagonal(H[f], np.where(d >= 0, 1.0, -1.0) * (1.0 + rng.random(n)))
    if m > 1:
        H[0, m - 1, m - 2] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    rot = []
    for f, g in rng.standard_normal((2, 2)):
        d = np.hypot(f, g)
        rot += [abs(f) / d, np.sign(f) * g / d]
    Ht = torch.tensor(H)
    rgopen.rg_ladder_plain(Ht, None, "open", m - 1, i, torch.tensor(rot), S, want_z=False)
    return Ht.numpy()


def _sig(kind, p):
    if kind == "alt":
        return tuple(l % 2 == 0 for l in range(p))
    return tuple(l == 0 or kind == "direct" for l in range(p))


def _plain_log(H, m, i, S):
    Ht = torch.tensor(H)
    log = torch.zeros((H.shape[0], H.shape[1], LOG), dtype=torch.float64)
    sweep_rg.rg_chase_plain(Ht, None, m, i, S, want_z=False, log=log)
    return Ht.numpy(), log.numpy()


def _written(log, m, i):
    """Every entry kernel rg A writes: L, R, ZR of each factor, r of factor 0."""
    return np.concatenate([log[:, m:i - 1, :27].ravel(), log[0, m:i - 1, 27]])


# (p, n, m, i, L, S): windows of i-1-m steps shorter than L, equal to L and
# not a multiple of it; m > 1; windows that end at n-1 (the ring close cut
# at the last row) and ones that end above it
CASES = [
    (2, 12, 1, 11, 2, "alt"),      # 9 steps, 5 batches, ends at n-1
    (2, 9, 2, 6, 5, "direct"),     # 3 steps < L
    (2, 14, 1, 13, 5, "inverse"),  # 11 steps: 5 + 5 + 1
    (3, 10, 1, 7, 5, "alt"),       # 5 steps == L
    (3, 7, 2, 4, 2, "direct"),     # one step
    (3, 11, 3, 10, 1, "inverse"),  # L = 1, ends at n-1
    (3, 12, 2, 10, 2, "alt"),
    (16, 15, 1, 14, 5, "alt"),     # 12 steps: 5 + 5 + 2
    (16, 12, 3, 10, 1, "direct"),
    (16, 11, 2, 9, 2, "inverse"),  # 6 steps == 3 L
]


@pytest.mark.parametrize("p,n,m,i,L,kind", CASES)
def test_rg_window_model_matches_plain_log(p, n, m, i, L, kind):
    S = _sig(kind, p)
    H = _opened(p, n, m, i, S, 1000 * p + 10 * n + L)
    Lf, Cf = rg_log_full(H, m, i, S)
    Lw, W, j0 = rg_log_windowed(H, m, i, S, L)
    assert np.array_equal(_written(Lw, m, i), _written(Lf, m, i))
    assert not np.isnan(_written(Lw, m, i)).any()
    # the last batch's window against the full copy, entry by entry
    held = ~np.isnan(W)
    r1, c1 = min(j0 + W.shape[1], i + 2, n), min(j0 - 1 + W.shape[2], i + 1)
    ref = np.full_like(W, np.nan)
    ref[:, :r1 - j0, :c1 - j0 + 1] = Cf[:, j0:r1, j0 - 1:c1]
    assert held[:, :min(r1, i) - j0, 1:c1 - j0 + 1].all()
    assert np.array_equal(W[held], ref[held])

    Hp, Lp = _plain_log(H, m, i, S)
    pert = 1.0 + 1e-16 * np.random.default_rng(1).standard_normal(H.shape)
    _, Lq = _plain_log(H * pert, m, i, S)
    wp, wq, ww = _written(Lp, m, i), _written(Lq, m, i), _written(Lw, m, i)
    sens = np.abs(wq - wp).max()
    assert np.abs(ww - wp).max() <= max(1e-15, 10 * sens) * np.abs(wp).max()

    Ha = torch.tensor(H)
    sweep_rg.rg_apply_log_plain(Ha, None, torch.tensor(np.nan_to_num(Lw)), m, i,
                                want_z=False)
    assert float(np.abs(Ha.numpy() - Hp).max()) <= 1e-13 * np.abs(H).max()


def test_rg_window_extents_are_enforced():
    # a block holds rows j0..j0+L+2 and columns j0-1..j0+L+1 only: a model
    # that reads one column or row further fails its index assert
    import torch_rg_window_host as wh
    win = wh._Window(2, 3, 14, 10)
    win.j0 = 2
    win.get(0, 2 + 5, 1)  # row j0+L+2, column j0-1: inside
    win.get(0, 2, 2 + 4)  # column j0+L+1: inside
    with pytest.raises(AssertionError):
        win.get(0, 2, 2 + 5)  # column j0+L+2: outside
    with pytest.raises(AssertionError):
        win.get(0, 2 + 6, 2)  # row j0+L+3: outside
    with pytest.raises(AssertionError):
        win.get(0, 1, 2)  # row j0-1: outside
    with pytest.raises(AssertionError):
        win.get(0, 2, 0)  # column j0-2: outside
    win.j0 = 8
    with pytest.raises(AssertionError):
        win.get(0, 9, 11)  # column i+1: outside, though inside j0+L+1
    win = wh._Window(2, 3, 10, 9)
    win.j0 = 6
    with pytest.raises(AssertionError):
        win.get(0, 10, 7)  # row n: outside, though inside j0+L+2


def test_rg_chase_on_the_cpu_is_the_plain_chase():
    # the rg_chase wrapper on CPU tensors is rg_chase_plain, bit for bit
    S = _sig("alt", 3)
    H = _opened(3, 10, 2, 8, S, 5)
    Z = np.linalg.qr(np.random.default_rng(6).standard_normal((3, 10, 10)))[0]
    Hk, Zk = torch.tensor(H), torch.tensor(Z)
    sweep_rg.rg_chase(Hk, Zk, 2, 8, S, want_z=True)
    Hp, Zp = torch.tensor(H), torch.tensor(Z)
    sweep_rg.rg_chase_plain(Hp, Zp, 2, 8, S, want_z=True)
    assert torch.equal(Hk, Hp) and torch.equal(Zk, Zp)


def test_rg_sweep_generate_on_the_cpu_is_the_plain_log():
    # the kernel rg A wrapper on a CPU tensor: rg_chase_plain's log, H unchanged
    S = _sig("direct", 3)
    H = _opened(3, 9, 1, 8, S, 8)
    Ht = torch.tensor(H)
    log = sweep_rg.rg_sweep_generate(Ht, 1, 8, S)
    assert torch.equal(Ht, torch.tensor(H))
    _, Lp = _plain_log(H, 1, 8, S)
    assert np.array_equal(log.numpy(), Lp)
