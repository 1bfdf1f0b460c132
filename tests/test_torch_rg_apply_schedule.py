"""The schedule of the real generalized apply kernels rg B0 and rg B, as a
numpy model, on the CPU.

``tests/torch_rg_apply_host.py`` models the schedule of
``csrc/sweep_rg.cu::rg_left_kernel`` and ``rg_right_kernel`` (lines in
tiles, positions in chunks staged in a ring with the log entries of their
steps, kAhead chunks ahead) and replays the design before it (one thread
per line).  Checks, on seeded real Hessenberg-triangular cycles after the
sweep's opening ladder:

* the model equals the replay bit for bit (``np.array_equal``), after B0
  and after B, with and without Z, on logs of random orthogonal 3x3
  transforms: p in {2, 3, 8}, odd and even n, the windows (1, n-1), an
  inner one, one step (i = m+2), two steps and (m, n-1), tiles, chunks and
  rings that do and do not divide the lines and the span;
* the model against ``rg_apply_log_plain`` (torch's 3x3 products round
  otherwise) on the logs of ``rg_chase_plain``, alternating and all-direct
  signatures: 1e-13 relative, the same exact structural zeros, the
  closing bulge kept, the logged r exact, and every column left of m-1
  untouched;
* a ring with one slot too few for B (a chunk released before its
  write-back) and a chunk that stages the wrong steps' log entries are
  refused.

No JAX: numpy, torch's CPU build and the port only.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import rgopen, sweep_rg
from torch_rg_apply_host import apply_model, model_left, random_log, replay_left, replay_parent


def _sig(kind, p):
    return tuple(l % 2 == 0 for l in range(p)) if kind == "alt" else (True,) * p


def _problem(p, n, m, i, S, seed):
    """A Hessenberg-triangular cycle with the window [m, i]'s boundaries
    deflated, after the opening ladder (the state the chase starts from),
    an orthogonal Z, and the rng for a log."""
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
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(p)])
    rot = []
    for f, g in rng.standard_normal((2, 2)):
        d = np.hypot(f, g)
        rot += [abs(f) / d, np.sign(f) * g / d]
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    rgopen.rg_ladder_plain(Ht, Zt, "open", m - 1, i, torch.tensor(rot), S, want_z=True)
    return Ht.numpy(), Zt.numpy(), rng


def _windows(n):
    """(1, n-1), an inner window, one step, two steps, (m, n-1) with m > 1."""
    return [(1, n - 1), (3, n - 4), (n // 3, n // 3 + 2), (n // 4, n // 4 + 3),
            (n // 2, n - 1)]


# (lines per tile, B0's and B's positions per chunk, chunks ahead): the
# kernels' own, and tiles, chunks and rings that do not divide the lines or
# the span
SIZES = [(16, 64, 32, 2), (5, 4, 6, 2), (8, 7, 5, 1), (3, 2, 3, 3), (32, 16, 16, 3)]

CASES = []
for p in (2, 3, 8):
    for n in (11, 36):
        for (m, i) in _windows(n):
            c = len(CASES)
            CASES.append((p, n, m, i, SIZES[c % len(SIZES)], c % 2 == 0))


@pytest.mark.parametrize("p,n,m,i,sizes,want_z", CASES)
def test_model_equals_parent(p, n, m, i, sizes, want_z):
    H, Z, rng = _problem(p, n, m, i, _sig("alt", p), 100 * p + n + m)
    log = random_log(rng, p, n, m, i)
    Z = Z if want_z else None
    lines, left_chunk, chunk, ahead = sizes
    Hl = model_left(H, log, m, i, cols=lines, chunk=left_chunk, ahead=ahead)
    assert np.array_equal(Hl, replay_left(H, log, m, i))
    Hp, Zp = replay_parent(H, Z, log, m, i)
    Hm, Zm = apply_model(H, Z, log, m, i, cols=lines, rows=lines, chunk=chunk,
                         left_chunk=left_chunk, ahead=ahead)
    assert not np.isnan(Hp).any()
    assert np.array_equal(Hm, Hp)
    assert Zm is None if Z is None else np.array_equal(Zm, Zp)


def _plain_log(H, m, i, S):
    log = torch.zeros((*H.shape[:2], sweep_rg.LOG), dtype=torch.float64)
    sweep_rg.rg_chase_plain(torch.tensor(H), None, m, i, S, want_z=False, log=log)
    return log


PLAIN_CASES = [(2, 20, 1, 19, "alt"), (3, 33, 2, 30, "direct"), (8, 17, 5, 9, "alt"),
               (2, 40, 1, 39, "direct"), (3, 9, 3, 5, "alt"), (4, 21, 7, 20, "direct"),
               (8, 26, 1, 25, "direct")]


@pytest.mark.parametrize("p,n,m,i,kind", PLAIN_CASES)
def test_model_matches_rg_apply_log_plain(p, n, m, i, kind):
    S = _sig(kind, p)
    H, Z, _ = _problem(p, n, m, i, S, 31 * p + n)
    log = _plain_log(H, m, i, S)
    Hm, Zm = apply_model(H, Z, log.numpy(), m, i)
    Ha, Za = torch.tensor(H), torch.tensor(Z)
    sweep_rg.rg_apply_log_plain(Ha, Za, log, m, i, want_z=True)
    Ha, Za = Ha.numpy(), Za.numpy()
    assert np.array_equal(Hm, replay_parent(H, Z, log.numpy(), m, i)[0])
    assert np.abs(Hm - Ha).max() <= 1e-13 * np.abs(H).max()
    assert np.abs(Zm - Za).max() <= 1e-13
    assert np.array_equal(Hm == 0.0, Ha == 0.0)  # the same exact zeros
    assert np.array_equal(Hm[:, :, :m - 1], H[:, :, :m - 1])  # columns left of m-1
    assert Hm[0, i, i - 2] != 0.0  # the closing bulge is kept
    for r in range(m, i + 1):
        assert not Hm[0, r, m - 1:(r - 1 if r < i else i - 2)].any()
        assert not Hm[1:, r, m - 1:r].any()
        if r <= i - 2:
            assert Hm[0, r, r - 1] == log[0, r, 27].item()


def test_chunk_released_before_its_write_back_is_refused():
    p, n, m, i = 2, 40, 1, 39
    H, Z, rng = _problem(p, n, m, i, _sig("alt", p), 5)
    log = random_log(rng, p, n, m, i)
    with pytest.raises(AssertionError, match="slot of live chunk"):
        apply_model(H, Z, log, m, i, chunk=4, left_chunk=4, ahead=2, right_slots=3)


def test_log_entry_not_staged_is_refused():
    p, n, m, i = 2, 40, 3, 37
    H, Z, rng = _problem(p, n, m, i, _sig("alt", p), 6)
    log = random_log(rng, p, n, m, i)

    def late(q0, w, m, i):  # the chunk's own positions' steps: two steps late
        return [k for k in range(q0, q0 + w) if m <= k <= i - 2]
    with pytest.raises(AssertionError, match="not staged"):
        model_left(H, log, m, i, chunk=8, stage=late)
