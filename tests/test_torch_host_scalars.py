"""The plain versions' scalar generations on the CPU: the Python-float paths
of ``ops/householder.py::_reflector_from`` (real tails of at most two
entries) and of ``ops/rotations.py::givens_real`` / ``givens_complex``
(two 0-dim tensors, through ``givens_host``) against the tensor code they
stand in for, bit for bit (signs of zero included), on seeded draws that
mix scales from 1e-310 to 1e300, exact and signed zeros.  No JAX program is
compiled.
"""
import numpy as np
import pytest
import torch

from periodicschurdecompositions_jl_torch.ops import householder
from periodicschurdecompositions_jl_torch.ops.rotations import givens_complex, givens_real

SCALES = [1.0, 1e-300, 1e300, 1e-160, 1e160, 5e-324 * 7, 1e-310]


def _bits(x):
    r = (torch.view_as_real(x) if x.is_complex() else x).reshape(-1).numpy()
    return [np.float64(v).tobytes() for v in r]


def _same(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and _bits(x) == _bits(y)
               for x, y in zip(a, b))


def _draw(rng, k):
    v = rng.standard_normal(k) * rng.choice(SCALES, k)
    mode = rng.integers(0, 6)
    if mode == 0:
        v[0] = 0.0
    elif mode == 1:
        v[0] = -0.0
    elif mode == 2:
        v[1:] = 0.0
    elif mode == 3:
        v[:] = 0.0
    return v


@pytest.mark.parametrize("k", [0, 1, 2])
def test_reflector_floats_are_the_tensor_code(k, monkeypatch):
    rng = np.random.default_rng(40 + k)
    xs = [torch.tensor(_draw(rng, k + 1)) for _ in range(1500)]
    fast = [householder._reflector_from(x[0], x[1:]) for x in xs]
    taken = sum(householder._reflector_from_floats(x[0], x[1:]) is not None for x in xs)
    monkeypatch.setattr(householder, "_reflector_from_floats", lambda a, t: None)
    for x, out in zip(xs, fast):
        assert _same(out, householder._reflector_from(x[0], x[1:])), x
    assert taken >= 1000


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_givens_on_0dim_tensors_is_the_tensor_code(cplx):
    rng = np.random.default_rng(7 + cplx)
    for _ in range(1500):
        v = _draw(rng, 4)
        if cplx:
            f, g = (torch.tensor(complex(v[0], v[1]), dtype=torch.complex128),
                    torch.tensor(complex(v[2], v[3]), dtype=torch.complex128))
            fn = givens_complex
        else:
            f, g = torch.tensor(v[0]), torch.tensor(v[2])
            fn = givens_real
        ref = tuple(t.reshape(()) for t in fn(f.reshape(1), g.reshape(1)))
        assert _same(fn(f, g), ref), v
