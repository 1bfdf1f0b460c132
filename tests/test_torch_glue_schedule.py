"""The staged schedule of kernel G (``csrc/glue.cu``) against the host glue.

``tests/torch_glue_host.py::glue_model`` computes G's packed buffer on the
kernel's schedule: row chunks of 32 rows, one a block, with a halo of two
rows above and three below, factor groups through a ring of slots as
``psd::apply_ring`` issues them (a slot poisoned before it is refilled),
the factor entries a factor a thread, the scan reduced per warp, block and
then by the last block.  Here it is held bit
for bit against ``host_glue`` (the numpy transcription of the float64
core's glue that the kernel and ``glue_plain`` are held to) on cycles of p
in {1, 2, 3, 16, 40} factors and n in {1, 2, 3, 5, 31, 33, 600}: windows
with l = i, i = 0, the whole matrix and a planted deflation (lnew > 0), at
its 1, 10, 16 and 20 under the default test and both ``slicot_*`` flags,
with the H100's shared memory; and, at its = 1, with chunks of 5 rows on
32 threads and with the least shared memory the kernel runs in (one
factor a group).  numpy
and torch on the CPU; no JAX.

Also ``ops.glue.unpack`` with the reused factor-entry arrays of the card's
path against a fresh unpack, call after call.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.ops import glue, pqr_real
from torch_glue_host import glue_model, glue_plan, glue_tight_optin, host_glue_of

CFGS = [AlgoConfig(), AlgoConfig(slicot_convg=True), AlgoConfig(slicot_shifts=True)]


def _cycle(p, n, seed):
    """A padded Hessenberg-triangular cycle (numpy, p x N x N): factors
    1..p-1 with diagonals of modulus 1..2, and H[0]'s subdiagonal
    negligible at row n // 3 (for n >= 3), so that the scan finds it."""
    rng = np.random.default_rng(seed)
    N = n + 1
    H = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
        d = rng.standard_normal(n)
        H[f, np.arange(n), np.arange(n)] = np.where(d >= 0, 1.0, -1.0) * (1 + rng.random(n))
    if n >= 3:
        H[0, n // 3, n // 3 - 1] = 1e-20
    return H


def _windows(n):
    w = {(n // 2, n // 2), (0, 0), (0, n - 1)}
    if n >= 3:
        w.add((max(n // 3 - 2, 0), n - 1))  # the planted hit: lnew = n // 3
    return sorted(w)


def _same(buf, h, p, n, i):
    """The model's packed buffer against the host glue: band, lnew, v0 and
    the factor entries the repair test and the 2x2 deflation read."""
    g = glue.unpack(buf, p, n, i)
    assert np.array_equal(g.hdiag, h.hdiag) and np.array_equal(g.hsub, h.hsub)
    assert np.array_equal(g.hsup, h.hsup)
    assert g.lnew == h.lnew and g.v0 == h.v0
    cols = [i - 1, i] if i >= 1 else [i]
    assert np.array_equal(g.D[:, cols], h.D[:, cols])
    if i >= 1:
        assert np.array_equal(g.U[:, i - 1], h.U[:, i - 1])
    for r in (i, g.lnew):
        assert g.S0[r] == h.S0[r]
    if g.lnew >= 1:
        assert g.D[0, g.lnew - 1] == h.D[0, g.lnew - 1]
    return g.lnew


@pytest.mark.parametrize("n", [1, 2, 3, 5, 31, 33, 600])
@pytest.mark.parametrize("p", [1, 2, 3, 16, 40])
def test_schedule_is_the_host_glue_bit_for_bit(p, n):
    H = _cycle(p, n, 1000 * p + n)
    diagonals = pqr_real._BandGather(p, n, "cpu")(torch.tensor(H))  # host_glue's gather
    lnews = set()
    for (l, i) in _windows(n):
        for its in (1, 10, 16, 20):
            for cfg in CFGS:
                h = host_glue_of(diagonals, n, l, i, its, cfg)
                lnews.add(_same(glue_model(H, n, l, i, its, cfg), h, p, n, i))
                if its == 1 and cfg is CFGS[0]:
                    for kw in ({"rows": 5, "threads": 32}, {"optin": glue_tight_optin(p)}):
                        _same(glue_model(H, n, l, i, its, cfg, **kw), h, p, n, i)
    if n >= 3:
        assert n // 3 in lnews  # the planted deflation was found


def test_plans_cover_the_ring_and_the_limit():
    # the headline: three groups of five factors in flight
    assert glue_plan(16) == 5
    assert glue_plan(40) == 13 and glue_plan(1) == 1
    assert glue_plan(40, optin=glue_tight_optin(40)) == 1
    assert glue_plan(40, optin=glue_tight_optin(40) + 8 * 3 * 4 * 37) == 2
    with pytest.raises(ValueError):
        glue_plan(200, optin=3000)


def test_reused_entries_unpack_as_fresh_ones():
    p, n = 3, 12
    H = _cycle(p, n, 5)
    Hp = torch.tensor(H)
    entries = glue._FactorEntries(p, n)
    for (l, i, its) in [(0, 11, 1), (4, 11, 2), (0, 3, 1), (0, 0, 1), (2, 9, 16), (0, 11, 10)]:
        buf = glue.glue_plain(Hp, n, l, i, its, AlgoConfig()).numpy()
        fresh = glue.unpack(buf, p, n, i)
        kept = glue.unpack(buf, p, n, i, entries)
        assert np.array_equal(kept.D, fresh.D) and np.array_equal(kept.U, fresh.U)
        assert np.array_equal(kept.S0, fresh.S0) and kept.lnew == fresh.lnew
        assert not kept.D.flags.writeable and not kept.U.flags.writeable
        kept.S0[kept.lnew] = 0.0  # the core's write stays in its own array
