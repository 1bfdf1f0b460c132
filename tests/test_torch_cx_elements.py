"""Complex element operations of the PyTorch port against the JAX package's.

Same inputs (numpy, seeded) through both, complex128 on the CPU, where both
evaluate op by op with correctly rounded division and sqrt: complex Givens,
``lmat``/``rmat_adj``, complex reflectors, ``safeprod_signed`` and the
sweep's shift chain (``qz_shift_plain`` against the same chain evaluated
with the JAX ``givens_complex``).  Tolerance 1e-15 relative to the
output's scale (a few ulp: the frameworks' complex products and absolute
values may round differently in the last bit).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from periodicschurdecompositions_jl_tpu.ops import householder as jh
from periodicschurdecompositions_jl_tpu.ops import rotations as jr
from periodicschurdecompositions_jl_tpu.utils.safeprod import safeprod_signed as jsafeprod
from periodicschurdecompositions_jl_torch.ops import householder as th
from periodicschurdecompositions_jl_torch.ops import rotations as tr
from periodicschurdecompositions_jl_torch.ops import sweep_cx
from periodicschurdecompositions_jl_torch.utils.safeprod import safeprod_signed

TOL = 1e-15


def _close(a, b, tol=TOL):
    a = np.asarray(a)
    b = np.asarray(b)
    scale = max(np.abs(b).max(initial=0.0), np.finfo(np.float64).tiny)
    assert np.abs(a - b).max(initial=0.0) <= tol * scale, (a, b)


def _cx_pairs():
    rng = np.random.default_rng(5)

    def c():
        return complex(*rng.standard_normal(2))
    out = [(c(), c()) for _ in range(8)]
    out += [(0j, 0j), (1.5 - 2j, 0j), (0j, -2 + 1j), (3.0 + 0j, 4.0 + 0j),
            (1e-300 + 2e-300j, -3e-300j), (2e300 - 1e300j, 1e300 + 0j)]
    return out


def test_givens_complex():
    for f, g in _cx_pairs():
        cj, sj, rj = jr.givens_complex(jnp.complex128(f), jnp.complex128(g))
        ct, st, rt = tr.givens_complex(torch.tensor(f, dtype=torch.complex128),
                                       torch.tensor(g, dtype=torch.complex128))
        for a, b in ((ct, cj), (st, sj), (rt, rj)):
            _close(a.numpy(), b)


def test_lmat_rmat_adj_complex():
    c = 0.6
    s = 0.48 - 0.64j
    ct = torch.tensor(c, dtype=torch.float64)
    st = torch.tensor(s, dtype=torch.complex128)
    _close(tr.lmat(ct, st).numpy(), jr.lmat(jnp.float64(c), jnp.complex128(s)))
    _close(tr.rmat_adj(ct, st).numpy(), jr.rmat_adj(jnp.float64(c), jnp.complex128(s)))


def _cx_vectors(k):
    rng = np.random.default_rng(20 + k)

    def v():
        return rng.standard_normal(k) + 1j * rng.standard_normal(k)
    out = [v() for _ in range(5)]
    out.append(np.zeros(k, complex))                # trivial reflector
    z = np.zeros(k, complex)
    z[0] = -2.5 + 1j
    out.append(z)                                   # zero tail, complex alpha
    out.append(v() * 1e-300)                        # underflow rescue
    out.append(v() * 1e300)                         # huge
    return out


@pytest.mark.parametrize("k", [2, 3])
def test_reflector_small_complex(k):
    for x in _cx_vectors(k):
        wj, tj, bj = jh.reflector_small(jnp.asarray(x))
        wt, tt, bt = th.reflector_small(torch.tensor(x))
        _close(wt.numpy(), wj)
        _close(tt.numpy(), tj)
        _close(bt.numpy(), bj)


@pytest.mark.parametrize("lo,hi", [(0, 8), (3, 6)])
def test_reflector_masked_complex(lo, hi):
    for x in _cx_vectors(8):
        wj, tj, bj = jh.reflector_masked(jnp.asarray(x), lo, hi)
        wt, tt, bt = th.reflector_masked(torch.tensor(x), lo, hi)
        _close(wt.numpy(), wj)
        _close(tt.numpy(), tj)
        _close(bt.numpy(), bj)


@pytest.mark.parametrize("S", [(True, True, True), (True, False, True, False),
                               (True, False, False)])
def test_safeprod_signed(S):
    rng = np.random.default_rng(len(S))
    p = len(S)
    cases = [rng.standard_normal(p) + 1j * rng.standard_normal(p),
             (rng.standard_normal(p) + 1j) * 1e150,
             (rng.standard_normal(p) + 1j) * 1e-150]
    z = rng.standard_normal(p) + 1j * rng.standard_normal(p)
    z[-1] = 0.0                                      # a zero in the last factor
    cases.append(z)
    for x in cases:
        aj, bj, sj = jsafeprod(jnp.asarray(x), S)
        at, bt, st = safeprod_signed(list(x), S)
        assert bt == float(bj) and st == int(sj)
        _close(at, complex(aj))


def test_qz_shift_plain_matches_jax_chain():
    rng = np.random.default_rng(8)
    p, n = 4, 9
    H = rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))
    for S in [(True,) * p, (True, False, True, False)]:
        for (a, b) in [(0, 8), (2, 5), (6, 7)]:
            c, s, _ = jr.givens_complex(jnp.complex128(1.0), jnp.complex128(1.0))
            for l in range(p - 1, 0, -1):
                hf, hl = H[l, a, a], H[l, b, b]
                if S[l]:
                    c, s, _ = jr.givens_complex(hf * c, hl * jnp.conj(s))
                else:
                    c, s, _ = jr.givens_complex(hl * c, -hf * jnp.conj(s))
                    s = -s
            c, s, _ = jr.givens_complex(H[0, a, a] * c - H[0, b, b] * jnp.conj(s),
                                        H[0, a + 1, a] * c)
            cs = sweep_cx.qz_shift(torch.tensor(H), a, b, S)    # CPU: plain version
            _close(cs.numpy(), np.array([complex(c), complex(s)]))
