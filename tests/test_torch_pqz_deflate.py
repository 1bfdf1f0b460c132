"""The port's deflation actions (``ops/pqz_deflate.py::DeflateCores``) on the
CPU against the JAX package's ``make_deflate_cores``.

A CPU tensor takes the plain versions (the card launches
``csrc/pqz_deflate.cu``; tests/test_torch_cuda.py holds the two against each
other there).  Seeded numpy draws of a periodic Hessenberg-triangular cycle
and unitary Z go through both packages: real p=4 with S=(T,T,F,T) at n=9
and complex p=3 with S=(T,F,T) at n=8; DEFLATE_POS on a direct factor,
DEFLATE_NEG on an inverted one chasing down and up, and CZSHIFT on the whole
matrix and on an inner window with an exact zero planted on a direct
factor's diagonal (its fill is exactly zero, so the identity branch runs and
the flag is set).  Each JAX core is jitted once per dtype (one module
fixture, six programs).

* H and Z within 1e-13 max|H|, the same exact zeros in H (both packages
  round without fused products here), the same flag;
* a CPU tensor never loads the CUDA kernels, and another device raises;
* ``pschur(A, 'R', S)`` takes DEFLATE_POS and DEFLATE_NEG on a cycle whose
  reduction keeps two planted exact zeros (``chip_smoke.singular_cycle``).
"""
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_torch as pt
import periodicschurdecompositions_jl_tpu  # noqa: F401  (enables x64)
from chip_smoke import singular_cycle
import jax
import jax.numpy as jnp
from periodicschurdecompositions_jl_tpu.ops.pqz_deflate import make_deflate_cores
from periodicschurdecompositions_jl_torch.ops import _cuda, pqz_complex, pqz_deflate, pqz_real

EPS = float(np.finfo(np.float64).eps)
SHAPES = {"real": ((True, True, False, True), 9), "complex": ((True, False, True), 8)}
# action, window and deflated entry (jlo, ldef, jdef, ilast) or CZSHIFT's
# window (jlo, ilast) and the diagonal entry j of a direct factor set to zero
CASES = {
    "pos": ("pos", (0, 1, 4, -1), None),
    "neg_down": ("neg", (0, 2, 6, -1), None),
    "neg_up": ("neg", (1, 2, 2, -2), None),
    "czshift": ("czshift", (0, -1), None),
    "czshift_identity": ("czshift", (1, -2), 4),
}


def _smlnum(n):
    return float(np.finfo(np.float64).tiny) * n / EPS


def _cycle(S, n, kind, seed, zero):
    rng = np.random.default_rng(seed)
    p = len(S)

    def draw(*shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if kind == "complex" else x
    H = np.stack([np.triu(draw(n, n), -1 if l == 0 else 0) for l in range(p)])
    if zero is not None:
        H[zero[0], zero[1], zero[1]] = 0.0
    Z = np.stack([np.linalg.qr(draw(n, n))[0] for _ in range(p)])
    return H, Z


@pytest.fixture(scope="module")
def jax_cores():
    out = {}
    for kind, (S, n) in SHAPES.items():
        dt = jnp.complex128 if kind == "complex" else jnp.float64
        pos, neg, cz = make_deflate_cores(p=len(S), n=n, S=S, dt=dt, rdt=jnp.float64,
                                          want_z=True, ulp=EPS, smlnum=_smlnum(n))
        out[kind] = {"pos": jax.jit(pos), "neg": jax.jit(neg), "czshift": jax.jit(cz)}
    return out


def _args(window, n):
    """The window with its negative indices counted from n."""
    return tuple(x + n if x < 0 else x for x in window)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", list(SHAPES))
def test_deflate_action_matches_jax(jax_cores, kind, case):
    S, n = SHAPES[kind]
    action, window, zero = CASES[case]
    args = _args(window, n)
    if action != "czshift":
        zero = (args[1], args[2])
    elif zero is not None:
        zero = (S.index(True, 1), zero)
    H, Z = _cycle(S, n, kind, 40 + list(CASES).index(case), zero)
    out = jax_cores[kind][action](jnp.asarray(H), jnp.asarray(Z),
                                  *[jnp.int32(a) for a in args])
    Hj, Zj = np.asarray(out[0]), np.asarray(out[1])
    cores = pqz_deflate.DeflateCores(len(S), S, True, EPS, _smlnum(n))
    Ht, Zt = torch.tensor(H), torch.tensor(Z)
    res = getattr(cores, f"{action}_core")(Ht, Zt, *args)
    assert res[0] is Ht and res[1] is Zt
    scale = np.abs(H).max()
    assert np.abs(Ht.numpy() - Hj).max() <= 1e-13 * scale
    assert np.abs(Zt.numpy() - Zj).max() <= 1e-13 * scale
    assert np.array_equal(Ht.numpy() == 0, Hj == 0)
    if action == "czshift":
        assert res[2] == bool(out[2])
        assert res[2] == (zero is not None)


def test_cpu_route_never_loads_the_kernels(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor loaded the CUDA kernels")
    monkeypatch.setattr(_cuda, "load", refuse)
    S, n = SHAPES["real"]
    H, Z = _cycle(S, n, "real", 3, None)
    cores = pqz_deflate.DeflateCores(len(S), S, True, EPS, _smlnum(n))
    before = dict(pqz_deflate.launches)
    cores.czshift_core(torch.tensor(H), torch.tensor(Z), 0, n - 1)
    cores.pos_core(torch.tensor(H), torch.tensor(Z), 0, 1, 3, n - 1)
    cores.neg_core(torch.tensor(H), torch.tensor(Z), 0, 2, 3, n - 1)
    assert pqz_deflate.launches == before


def test_other_devices_raise():
    cores = pqz_deflate.DeflateCores(2, (True, False), False, EPS, _smlnum(4))
    H = torch.zeros((2, 4, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cores.czshift_core(H, None, 0, 3)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_pschur_takes_deflate_pos_and_neg(kind):
    p, n = 8, 16
    S = tuple(l % 2 == 0 for l in range(p))
    A = singular_cycle(kind, p, n, 5)
    P = pt.pschur(torch.tensor(A), "R", S=S)
    info = (pqz_complex if kind == "complex" else pqz_real).last_info
    assert info["converged"] and info["deflate_pos"] >= 1 and info["deflate_neg"] >= 1
    ok, rep = pt.check_psd(P, A, tol=200.0)
    assert ok, rep
