"""The schedule of the complex apply kernels cx B0 and cx B, as a numpy
model, on the CPU.

``tests/torch_cx_apply_host.py`` models the schedule of
``csrc/sweep_cx.cu::qz_left_kernel`` and ``qz_right_kernel`` (lines in
tiles, positions in chunks staged in a ring with the log entries of their
steps, kAhead chunks ahead) and replays the design before it (one thread
per line).  Checks, on seeded complex Hessenberg-triangular cycles:

* the model equals the replay bit for bit (``np.array_equal``), after B0
  and after B, on logs of random unitary 2x2 rotations: p in {1, 2, 3}, odd
  and even n, the windows (0, n-1), (2, n-3), (k, k+1), (k, k+2) and
  (m, n-1), tiles, chunks and rings that do and do not divide the lines
  and the span, with and without Z;
* the model against ``qz_apply_log_plain`` (torch's 2x2 products round
  otherwise) on the logs of ``qz_sweep_plain``, alternating and
  all-direct signatures: 1e-13 relative, the same exact structural zeros,
  the logged subdiagonal exact, and every column left of m untouched;
* a ring with one slot too few for B (a chunk released before its
  write-back) and a chunk that stages the wrong steps' log entries are
  refused.

No JAX: numpy, torch's CPU build and the port only.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import sweep_cx
from torch_cx_apply_host import apply_model, model_left, random_log, replay_left, replay_parent


def _problem(p, n, m, i, seed):
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    H = np.zeros((p, n, n), complex)
    H[0] = np.triu(cplx(n, n), -1)
    for f in range(1, p):
        H[f] = np.triu(cplx(n, n))
        d = cplx(n)
        np.fill_diagonal(H[f], d / np.abs(d) * (1.0 + rng.random(n)))
    if m > 0:
        H[0, m, m - 1] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    Z = np.stack([np.linalg.qr(cplx(n, n))[0] for _ in range(p)])
    return H, Z, rng


def _windows(n):
    """(0, n-1), (2, n-3), one step, two steps, (m, n-1) with m > 0."""
    return [(0, n - 1), (2, n - 3), (n // 3, n // 3 + 1), (n // 4, n // 4 + 2),
            (n // 2, n - 1)]


# (lines per tile, B0's and B's positions per chunk, chunks ahead): the
# kernels' own, and tiles, chunks and rings that do not divide the lines or
# the span
SIZES = [(16, 32, 24, 2), (5, 4, 6, 2), (8, 5, 5, 1), (3, 7, 4, 3), (32, 16, 16, 3)]

CASES = []
for p in (1, 2, 3):
    for n in (9, 34):
        for (m, i) in _windows(n):
            c = len(CASES)
            CASES.append((p, n, m, i, SIZES[c % len(SIZES)], c % 2 == 0))


@pytest.mark.parametrize("p,n,m,i,sizes,want_z", CASES)
def test_model_equals_parent(p, n, m, i, sizes, want_z):
    H, Z, rng = _problem(p, n, m, i, 100 * p + n + m)
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


def _plain_log(H, m, i, cs, S):
    log = torch.zeros((*H.shape[:2], sweep_cx.LOG), dtype=torch.complex128)
    sweep_cx.qz_sweep_plain(torch.tensor(H), None, m, i, torch.tensor(cs), S, want_z=False,
                            log=log)
    return log


def _sig(kind, p):
    return tuple(l % 2 == 0 for l in range(p)) if kind == "alt" else (True,) * p


PLAIN_CASES = [(1, 20, 0, 19, "direct"), (3, 33, 2, 30, "alt"), (4, 17, 5, 9, "direct"),
               (2, 40, 0, 39, "alt"), (3, 9, 3, 5, "alt"), (2, 21, 7, 20, "direct")]


@pytest.mark.parametrize("p,n,m,i,kind", PLAIN_CASES)
def test_model_matches_qz_apply_log_plain(p, n, m, i, kind):
    H, Z, rng = _problem(p, n, m, i, 31 * p + n)
    f, g = rng.standard_normal(2) + 1j * rng.standard_normal(2)
    d = np.hypot(abs(f), abs(g))
    cs = np.array([abs(f) / d, (f / abs(f)) * np.conj(g) / d])
    log = _plain_log(H, m, i, cs, _sig(kind, p))
    Hm, Zm = apply_model(H, Z, log.numpy(), m, i)
    Ha, Za = torch.tensor(H), torch.tensor(Z)
    sweep_cx.qz_apply_log_plain(Ha, Za, log, m, i, want_z=True)
    Ha, Za = Ha.numpy(), Za.numpy()
    assert np.array_equal(Hm, replay_parent(H, Z, log.numpy(), m, i)[0])
    assert np.abs(Hm - Ha).max() <= 1e-13 * np.abs(H).max()
    assert np.abs(Zm - Za).max() <= 1e-13
    assert np.array_equal(Hm == 0.0, Ha == 0.0)  # the same exact zeros
    assert np.array_equal(Hm[:, :, :m], H[:, :, :m])  # columns left of m untouched
    for r in range(m + 1, i + 1):
        assert not Hm[0, r, m:r - 1].any() and not Hm[1:, r, m:r].any()
        if r < i:
            assert Hm[0, r, r - 1] == log[0, r, 12].item()


def test_chunk_released_before_its_write_back_is_refused():
    p, n, m, i = 2, 40, 0, 39
    H, Z, rng = _problem(p, n, m, i, 5)
    log = random_log(rng, p, n, m, i)
    with pytest.raises(AssertionError, match="slot of live chunk"):
        apply_model(H, Z, log, m, i, chunk=4, left_chunk=4, ahead=2, right_slots=3)


def test_log_entry_not_staged_is_refused():
    p, n, m, i = 2, 40, 3, 37
    H, Z, rng = _problem(p, n, m, i, 6)
    log = random_log(rng, p, n, m, i)

    def late(q0, w, m, i):  # the chunk's own positions' steps: one step late
        return [k for k in range(q0, q0 + w) if m <= k < i]
    with pytest.raises(AssertionError, match="not staged"):
        model_left(H, log, m, i, chunk=8, stage=late)
