"""The correctly rounded CPU square root under the port's reflectors and
rotations (``ops/rotations.py::sqrt_rn``).

torch's CPU float64 ``sqrt`` is not correctly rounded: about 0.7% of
arguments come out one ulp off.  Every tensor square root of
``ops/householder.py`` (``_scaled_norm``, ``_hyp2``, ``_hyp3``) and of the
tensor Givens code of ``ops/rotations.py`` takes numpy's correctly rounded
one on the CPU, as ``ops/glue.py`` and ``ops/smallschur.py`` already did;
CUDA tensors keep ``torch.sqrt`` (CUDA's float64 sqrt is correctly rounded).

* ``reflector_small`` (real and complex) and ``givens_real`` /
  ``givens_complex`` on arguments ``[1, t]`` whose norm ``sqrt(1 + t*t)``
  torch rounds one ulp off: beta and r equal numpy's correctly rounded
  values exactly.
* the port's ``pqr_real_core`` on the five p=3 n=40 draws (seeds 70, 0-3)
  reads at most 32 eps residual (the reference's contract) with
  orthonormality under 10 eps n; with torch's square root it read 32.9
  and 32.8 eps on seeds 70 and 0.  No JAX program is compiled.
"""
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_core
from periodicschurdecompositions_jl_torch.ops.householder import reflector_small
from periodicschurdecompositions_jl_torch.ops.pqr_real import pqr_real_core
from periodicschurdecompositions_jl_torch.ops.rotations import (givens_complex, givens_real,
                                                               sqrt_rn)

EPS = float(np.finfo(np.float64).eps)


def torch_off_arguments(k=8):
    """k values t in (0.1, 0.9) whose 1 + t*t torch's CPU sqrt rounds
    otherwise than numpy's (a seeded search; all of them if torch rounds
    correctly)."""
    t = np.random.default_rng(0).uniform(0.1, 0.9, 20000)
    a = 1.0 + t * t
    off = torch.sqrt(torch.from_numpy(a)).numpy() != np.sqrt(a)
    return t[off][:k] if off.any() else t[:k]


T_OFF = torch_off_arguments()


def test_sqrt_rn_is_numpys():
    a = 1.0 + T_OFF * T_OFF
    assert np.array_equal(sqrt_rn(torch.from_numpy(a)).numpy(), np.sqrt(a))
    assert np.array_equal(sqrt_rn(torch.tensor(a[0])).numpy(), np.sqrt(a[0]))


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_reflector_beta_is_correctly_rounded(cplx):
    # x = [1, t]: xnorm = |t|, beta = -sqrt(1 + t*t) (the scaled hypot of
    # the JAX package, with max-scale 1)
    for t in T_OFF:
        x = torch.tensor([1.0, t], dtype=torch.complex128 if cplx else torch.float64)
        _, _, beta = reflector_small(x)
        assert float(beta) == -np.sqrt(1.0 + t * t), t


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_givens_r_is_correctly_rounded(cplx):
    f = torch.ones(len(T_OFF), dtype=torch.float64)
    g = torch.from_numpy(T_OFF.copy())
    if cplx:
        c, s, r = givens_complex(f.to(torch.complex128), g.to(torch.complex128))
        r = r.real
    else:
        c, s, r = givens_real(f, g)
    d = np.sqrt(1.0 + T_OFF * T_OFF)
    assert np.array_equal(r.numpy(), d)
    assert np.array_equal(c.numpy(), 1.0 / d)


@pytest.mark.parametrize("seed", [70, 0, 1, 2, 3])
def test_real_core_meets_the_residual_contract(seed):
    A = np.random.default_rng(seed).standard_normal((3, 40, 40))
    H, Q = phessenberg_core(torch.tensor(A))
    T, Z, wr, wi, ok = pqr_real_core(H, Z=Q)
    assert ok
    P = pt.PeriodicSchur(Ts=T, Zs=Z, values=torch.complex(torch.tensor(wr), torch.tensor(wi)))
    okc, rep = pt.check_psd(P, A, qtol=10.0, tol=32.0)
    assert okc, rep
