"""The port's signed periodic Hessenberg-triangular reduction on the CPU
against the JAX package's ``phessenberg_signed_core``.

A CPU tensor takes ``phessenberg_signed_core_plain`` (the card launches
``csrc/hess_signed.cu``; tests/test_torch_cuda.py holds the two against each
other there).  Seeded numpy draws go through both packages; three JAX
programs are compiled, once each, through one module fixture: p=2 with
S=(T,F) at n=7 (real), p=3 with S=(T,F,F) at n=7 (complex), and p=4 with an
alternating S at n=5 (real) with an exact zero planted on the diagonal of
the last factor, an inverted one that stage 1 leaves triangular.

* H within 1e-12 max|A|, Q within 1e-12, the similarity contract
  Q^H A Q = H within 1e-12 max|A| and exact structural zeros;
* n = 1 and 2 (no Givens chain) against the contract alone;
* a CPU tensor never loads the CUDA kernels.
"""
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp
from periodicschurdecompositions_jl_tpu.ops.hessenberg import (
    phessenberg_signed_core as jhess_signed)
from periodicschurdecompositions_jl_torch.ops import _cuda, hessenberg

ALT4 = (True, False, True, False)
CASES = {"p2_real": ((True, False), 7, "real"),
         "p3_complex": ((True, False, False), 7, "complex"),
         "p4_alternating_zero": (ALT4, 5, "zero")}


def _cycle(S, n, kind, seed):
    rng = np.random.default_rng(seed)
    p = len(S)
    A = rng.standard_normal((p, n, n))
    if kind == "complex":
        A = A + 1j * rng.standard_normal((p, n, n))
    if kind == "zero":  # exact zero on an inverted factor's diagonal
        A[p - 1] = np.triu(A[p - 1])
        A[p - 1, 2, 2] = 0.0
    return A


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for k, (name, (S, n, kind)) in enumerate(CASES.items()):
        A = _cycle(S, n, kind, 31 + k)
        Hj, Qj = jhess_signed(jnp.asarray(A), S, want_q=True)
        out[name] = (A, np.asarray(Hj), np.asarray(Qj))
    return out


def _contract(A, H, Q, S):
    p = len(S)
    assert np.all(np.tril(H[0], -2) == 0)
    for l in range(1, p):
        assert np.all(np.tril(H[l], -1) == 0)
    for l in range(p):
        a, b = (l, (l + 1) % p) if S[l] else ((l + 1) % p, l)
        R = Q[a].conj().T @ A[l] @ Q[b]
        assert np.abs(R - H[l]).max() <= 1e-12 * np.abs(A).max()


@pytest.mark.parametrize("name", list(CASES))
def test_signed_reduction_matches_jax(jax_results, name):
    S = CASES[name][0]
    A, Hj, Qj = jax_results[name]
    H, Q = hessenberg.phessenberg_signed_core(torch.tensor(A), S)
    scale = np.abs(A).max()
    assert np.abs(H.numpy() - Hj).max() <= 1e-12 * scale
    assert np.abs(Q.numpy() - Qj).max() <= 1e-12
    _contract(A, H.numpy(), Q.numpy(), S)
    Hn, Qn = hessenberg.phessenberg_signed_core(torch.tensor(A), S, want_q=False)
    assert Qn is None and torch.equal(Hn, H)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_signed_reduction_without_chains(n, kind):
    S = (True, False, True)
    A = _cycle(S, n, kind, 7 + n)
    H, Q = hessenberg.phessenberg_signed_core(torch.tensor(A), S)
    _contract(A, H.numpy(), Q.numpy(), S)


def test_cpu_tensor_never_loads_the_kernels(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached _cuda.load")
    monkeypatch.setattr(_cuda, "load", refuse)
    before = hessenberg.launches["hess_signed"]
    for kind in ("real", "complex"):
        A = torch.tensor(_cycle(ALT4, 6, kind, 5))
        H, Q = hessenberg.phessenberg_signed_core(A, ALT4)
        _contract(A.numpy(), H.numpy(), Q.numpy(), ALT4)
    assert hessenberg.launches["hess_signed"] == before
