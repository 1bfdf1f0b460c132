"""Kernel G of the port (``ops/glue.py``) against the JAX kernel and the host path.

* ``glue_plain`` against the JAX package's Pallas kernel G
  (``ops/pallas_glue.py``, interpret mode) on the draw of
  ``tests/test_pallas_glue.py::test_glue_kernel_band_parity``: the JAX
  kernel computes in float-float with a per-factor binary renormalization,
  so the band (rescaled by 2^bexp) agrees within 1e-13 of its largest
  entry, lnew is equal and v0 agrees within 1e-12.
* ``glue_products_scan_shift`` on a CPU tensor (``glue_plain``) against a
  numpy transcription of the float64 core's host glue
  (``tests/torch_glue_host.py``): bit for bit, including the factor entries
  the repair test and the 2x2 deflation read, over 42 windows of one state
  (enough square roots that a sqrt one ulp off, as torch's CPU sqrt is for
  about 0.7% of arguments, shows).
* ``pqr_real_core`` (kernel G's plain version on the CPU) against the same
  core with the numpy host glue in its place: the same iteration, so niter,
  T, Z and the eigenvalues are bit for bit the same; no kernel launches on
  the CPU.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from periodicschurdecompositions_jl_tpu.config import default_config as jcfg
from periodicschurdecompositions_jl_tpu.ops import ff
from periodicschurdecompositions_jl_tpu.ops.ff import FF
from periodicschurdecompositions_jl_tpu.ops.hessenberg import phessenberg_core as jhess
from periodicschurdecompositions_jl_tpu.ops.pallas_glue import (
    glue_products_scan_shift as jglue)
from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.ops import glue, pqr_real
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_core
from torch_glue_host import host_glue

EPS = float(np.finfo(np.float64).eps)


def _padded(H):
    p, n, _ = H.shape
    Hp = torch.zeros((p, n + 1, n + 1), dtype=torch.float64)
    Hp[:, :n, :n] = torch.as_tensor(H)
    return Hp


def test_plain_matches_the_jax_kernel(rng):
    p, n = 4, 24
    A = rng.standard_normal((p, n, n))
    H64 = np.array(jhess(jnp.asarray(A), want_q=False)[0])
    Hf = ff.from_f64(jnp.asarray(H64))
    N = n + 1
    pad = lambda x: jnp.zeros((p, N, N), jnp.float32).at[:, :n, :n].set(x)
    hd, hs, hu, bexp, _, lnew_j, _, v0_j = jglue(
        FF(pad(Hf.hi), pad(Hf.lo)), n, jnp.int32(0), jnp.int32(n - 1), jnp.int32(1),
        jcfg, interpret=True)
    g = glue.unpack(glue.glue_plain(_padded(H64), n, 0, n - 1, 1, AlgoConfig()).numpy(),
                    p, n, n - 1)
    e = 2.0 ** float(np.asarray(bexp))
    for a, b in ((hd, g.hdiag), (hs, g.hsub), (hu, g.hsup)):
        ta = np.asarray(a) * e
        assert np.abs(b - ta).max() <= 1e-13 * np.abs(ta).max()
    assert g.lnew == int(lnew_j) == 0
    v0j = np.asarray(v0_j.hi, np.float64) + np.asarray(v0_j.lo, np.float64)
    assert np.abs(np.asarray(g.v0) - v0j).max() <= 1e-12


@functools.lru_cache(maxsize=1)
def _state():
    """A reduced p=5 n=40 cycle with a negligible subdiagonal of H[0] at row
    21 (the scan finds it for some tests and not for others)."""
    A = np.random.default_rng(17).standard_normal((5, 40, 40))
    H, _ = phessenberg_core(torch.tensor(A), want_q=False)
    Hp = _padded(H)
    Hp[0, 21, 20] = 1e-17
    return Hp


# windows [l, i]: every i, with l spread below it, and the edges
_WINDOWS = [(0, 39), (4, 30), (22, 23), (0, 0), (5, 5)] + [
    ((7 * i) % (i - 1), i) for i in range(3, 40)]


@pytest.mark.parametrize("its", [1, 10, 16, 20])
@pytest.mark.parametrize("cfg", [AlgoConfig(), AlgoConfig(slicot_convg=True),
                                 AlgoConfig(slicot_shifts=True)],
                         ids=["default", "slicot_convg", "slicot_shifts"])
def test_plain_is_the_host_path_bit_for_bit(cfg, its):
    Hp = _state()
    n = Hp.shape[1] - 1
    for (l, i) in _WINDOWS:
        g = glue.glue_products_scan_shift(Hp, n, l, i, its, cfg)
        h = host_glue(Hp, n, l, i, its, cfg)
        D, U, S0, lnew = h.D, h.U, h.S0, h.lnew
        assert np.array_equal(g.hdiag, h.hdiag) and np.array_equal(g.hsub, h.hsub)
        assert np.array_equal(g.hsup, h.hsup)
        assert g.lnew == lnew
        assert g.v0 == h.v0
        # the entries the repair test and the 2x2 deflation read
        cols = [i - 1, i] if i >= 1 else [i]
        assert np.array_equal(g.D[:, cols], D[:, cols])
        if i >= 1:
            assert np.array_equal(g.U[:, i - 1], U[:, i - 1])
        for r in (i, lnew):
            assert g.S0[r] == S0[r]
        assert g.D[0, max(lnew - 1, 0)] == D[0, max(lnew - 1, 0)]


@pytest.mark.parametrize("case", ["p3n20", "graded", "early_qr", "slicot"])
def test_core_is_the_host_glue_core_bit_for_bit(rng, case, monkeypatch):
    cfg = AlgoConfig()
    if case == "graded":  # tests/test_pallas_glue.py::test_glue_kernel_graded_scale
        A = rng.standard_normal((6, 16, 16)) * (10.0 ** rng.integers(-6, 7, 6))[:, None, None]
    else:
        A = rng.standard_normal((3, 20, 20))
        if case == "early_qr":
            cfg = AlgoConfig(allow_early_qr=True)
        elif case == "slicot":
            cfg = AlgoConfig(slicot_convg=True, slicot_shifts=True)
    H, Q = phessenberg_core(torch.tensor(A))
    before = glue.launches["glue"]
    out = pqr_real.pqr_real_core(H, Z=Q, cfg=cfg, with_info=True)
    assert glue.launches["glue"] == before
    monkeypatch.setattr(pqr_real, "glue_products_scan_shift", host_glue)
    ref = pqr_real.pqr_real_core(H, Z=Q, cfg=cfg, with_info=True)
    assert ref[4] and out[4]
    assert out[5] == ref[5]
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    assert np.array_equal(out[2], ref[2]) and np.array_equal(out[3], ref[3])
