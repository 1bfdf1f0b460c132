"""The PyTorch port's complex single-shift QZ sweep against the JAX package's
complex128 oracle.

* ``qz_sweep_plain`` (the interleaved reference order) against
  ``ref_qz_sweep_np`` of tests/test_pallas_cx.py: the same arithmetic over
  a short chain, tolerance 1e-13 relative to max|H| (1e-13 for Z);
* ``qz_apply_log_plain`` (the plain twin of the CUDA kernels B0/B)
  replaying the plain sweep's own log in the deferred order: exact in exact
  arithmetic, tolerance 1e-13; it writes the structural zeros exactly and
  leaves H[0] left of the window untouched.

The CUDA kernels are checked against these plain versions in
tests/test_torch_cuda.py (needs a card).
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import sweep_cx
from test_pallas_cx import _enforce, _mk_problem, ref_qz_sweep_np

CASES = [
    (1, 8, (True,), 0, 7),
    (2, 8, (True, False), 0, 7),
    (4, 10, (True, False, True, False), 0, 9),
    (3, 12, (True, True, False), 2, 8),      # interior window
    (2, 6, (True, False), 2, 3),             # single-step window
]


def _structure_exact(H):
    assert np.all(np.tril(H[0], -2) == 0)
    for f in range(1, H.shape[0]):
        assert np.all(np.tril(H[f], -1) == 0)


def _problem(p, n, S, i, seed):
    H, Z, c0, s0 = _mk_problem(p, n, S, np.random.default_rng(seed))
    if i + 1 < n:
        H[0][i + 1, i] = 0.0      # the window's bottom boundary is deflated
    return H, Z, c0, s0


@pytest.mark.parametrize("p,n,S,m,i", CASES)
def test_plain_qz_sweep_matches_ref_qz_sweep_np(p, n, S, m, i):
    H0, Z0, c0, s0 = _problem(p, n, S, i, p * 100 + n)
    Href, Zref = ref_qz_sweep_np(H0, Z0, S, m, i, c0, s0)
    H, Z = torch.tensor(H0), torch.tensor(Z0)
    cs = torch.tensor([c0 + 0j, s0])
    sweep_cx.qz_sweep(H, Z, m, i, cs, S, want_z=True)   # CPU -> plain version
    H, Z = H.numpy(), Z.numpy()
    assert np.abs(H - _enforce(Href)).max() <= 1e-13 * np.abs(H0).max()
    assert np.abs(Z - Zref).max() <= 1e-13
    _structure_exact(H)


def test_plain_qz_sweep_no_z():
    p, n, S, m, i = 3, 10, (True, False, True), 0, 9
    H0, Z0, c0, s0 = _problem(p, n, S, i, 5)
    Href, _ = ref_qz_sweep_np(H0, Z0, S, m, i, c0, s0)
    H = torch.tensor(H0)
    sweep_cx.qz_sweep(H, None, m, i, torch.tensor([c0 + 0j, s0]), S, want_z=False)
    assert np.abs(H.numpy() - _enforce(Href)).max() <= 1e-13 * np.abs(H0).max()


@pytest.mark.parametrize("p,n,S,m,i", CASES)
def test_deferred_apply_replays_the_qz_sweep(p, n, S, m, i):
    H0, Z0, c0, s0 = _problem(p, n, S, i, p * 100 + n + 1)
    if m > 0:
        H0[0][m, m - 1] = 0.3    # the window-boundary column must be kept
    cs = torch.tensor([c0 + 0j, s0])
    H, Z = torch.tensor(H0), torch.tensor(Z0)
    log = torch.zeros((p, n, sweep_cx.LOG), dtype=torch.complex128)
    sweep_cx.qz_sweep_plain(H, Z, m, i, cs, S, want_z=True, log=log)
    Ha, Za = torch.tensor(H0), torch.tensor(Z0)
    sweep_cx.qz_apply_log_plain(Ha, Za, log, m, i, want_z=True)
    assert float((Ha - H).abs().max()) <= 1e-13 * np.abs(H0).max()
    assert float((Za - Z).abs().max()) <= 1e-13
    _structure_exact(Ha.numpy())
    assert torch.equal(Ha[0, :, :m], torch.tensor(H0[0][:, :m]))
    # the regenerated subdiagonal is the logged value, exactly
    for k in range(m + 1, i):
        assert Ha[0, k, k - 1] == log[0, k, 12]
