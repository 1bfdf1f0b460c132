"""The port's utilities against the JAX package's, on the CPU.

* ``save_decomposition`` / ``load_decomposition`` (``utils/io.py``): a file
  written by either package loads in the other bit for bit, for
  PeriodicSchur (with and without Z), GeneralizedPeriodicSchur and
  PartialPeriodicSchur;
* a checkpointed ``partial_pschur`` resumes bit for bit: the run stopped
  after two restarts and resumed gives exactly the uninterrupted run's
  result; a checkpoint of another shape raises;
* ``FacChecker`` gives the JAX package's drift, exactly, on the same (H, Z);
* ``balance_pcycle`` equals the JAX package's bit for bit on the draws of
  ``tests/test_balance.py`` (and a complex one);
* ``eigvecs_partial`` against the JAX package's on the same
  PartialPeriodicSchur (``utils/interop.py::partial_from_jax``): within
  1e-12 of the largest entry.

The decompositions come from the port on the CPU (``pschur`` at small n,
``partial_pschur``) and reach the JAX package's types as numpy arrays; no
JAX core is compiled.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import periodicschurdecompositions_jl_tpu as psd
from periodicschurdecompositions_jl_tpu.models.krylov import partial_pschur as jax_partial
from periodicschurdecompositions_jl_tpu.models.vectors import eigvecs_partial as jax_evp
from periodicschurdecompositions_jl_tpu.utils.balance import balance_pcycle as jax_balance
from periodicschurdecompositions_jl_tpu.utils import io as jio
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.models.vectors import eigvecs_partial
from periodicschurdecompositions_jl_torch.utils.interop import partial_from_jax

from torch_krylov_host import mkmats


@pytest.fixture(scope="module")
def decomps():
    rng = np.random.default_rng(31)
    A = rng.standard_normal((3, 6, 6))
    P = pt.pschur(torch.tensor(A), "R")
    Pnz = pt.pschur(torch.tensor(A), "L", want_z=False)
    G = pt.pschur(torch.tensor(rng.standard_normal((2, 5, 5)) + 3 * np.eye(5)), "R",
                  S=(True, False))
    Gc = pt.pschur(torch.tensor(rng.standard_normal((3, 4, 4))
                                + 1j * rng.standard_normal((3, 4, 4))), "R",
                   S=(True, False, True))
    K, _ = pt.partial_pschur(torch.tensor(mkmats(rng, 2, 20)), 3, "LM", seed=4)
    return {"schur": P, "schur_no_z": Pnz, "gen": G, "gen_cx": Gc, "partial": K}


_FIELDS = {"PeriodicSchur": ("Ts", "Zs", "values"),
           "GeneralizedPeriodicSchur": ("Ts", "Zs", "alpha", "beta", "alphascale"),
           "PartialPeriodicSchur": ("Ts", "Vs", "values", "residuals")}
_META = ("orientation", "schurindex")


def _to_jax(P):
    """The same decomposition as the JAX package's type (numpy -> jnp)."""
    def a(x):
        return None if x is None else jnp.asarray(x.numpy())
    kind = type(P).__name__
    kw = {f: a(getattr(P, f)) for f in _FIELDS[kind]}
    kw.update({m: getattr(P, m) for m in _META})
    if kind == "GeneralizedPeriodicSchur":
        kw["S"] = P.S
    return getattr(psd, kind)(**kw)


def _same_bits(P, Q):
    """Field by field: equal dtype, shape and bytes (tensors or arrays)."""
    assert type(P).__name__ == type(Q).__name__
    for f in _FIELDS[type(P).__name__]:
        x, y = getattr(P, f), getattr(Q, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (f, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), f
    for m in _META:
        assert getattr(P, m) == getattr(Q, m)
    if hasattr(P, "S"):
        assert tuple(P.S) == tuple(Q.S)


@pytest.mark.parametrize("case", ["schur", "schur_no_z", "gen", "gen_cx", "partial"])
def test_decomposition_files_cross_packages(decomps, case, tmp_path):
    P = decomps[case]
    f = str(tmp_path / "port.npz")
    pt.save_decomposition(f, P)
    _same_bits(P, jio.load_decomposition(f))          # port -> JAX
    _same_bits(P, pt.load_decomposition(f, device="cpu"))
    g = str(tmp_path / "jax.npz")
    jio.save_decomposition(g, _to_jax(P))
    Q = pt.load_decomposition(g, device="cpu")         # JAX -> port
    _same_bits(P, Q)
    assert all(getattr(Q, f).device.type == "cpu"
               for f in _FIELDS[type(Q).__name__] if getattr(Q, f) is not None)


def test_load_decomposition_goes_to_the_card_by_default(decomps, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    f = str(tmp_path / "p.npz")
    pt.save_decomposition(f, decomps["schur"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.load_decomposition(f)
    with pytest.raises(TypeError):
        pt.save_decomposition(f, object())


def test_krylov_checkpoint_resumes_bit_for_bit(tmp_path):
    rng = np.random.default_rng(1234)
    p, n = 3, 40
    A = torch.tensor(rng.standard_normal((p, n, n)))
    kw = dict(nev=3, which="LM", mindim=6, maxdim=12, seed=7)
    ref, href = pt.partial_pschur(A, **kw)
    f = str(tmp_path / "krylov.npz")
    _, hcut = pt.partial_pschur(A, restarts=2, checkpoint=f, **kw)
    assert not hcut.converged and hcut.nprods < href.nprods  # the run was cut
    got, hgot = pt.partial_pschur(A, checkpoint=f, **kw)
    assert hgot.converged and hgot.nprods == href.nprods
    for name in ("Ts", "Vs", "values", "residuals"):
        assert torch.equal(getattr(ref, name), getattr(got, name)), name
    with pytest.raises(ValueError, match="mismatch"):
        pt.partial_pschur(A[:, :n - 2, :n - 2].clone(), checkpoint=f, **kw)


def test_facchecker_matches_jax():
    rng = np.random.default_rng(1234)
    A = rng.standard_normal((3, 6, 6))
    P = pt.pschur(torch.tensor(A), "R")
    H, Z = P.Ts.numpy(), P.Zs.numpy()
    fc, fj = pt.FacChecker(A), psd.FacChecker(A)
    drift = fc("after pschur", P.Ts, P.Zs, verbose=False)
    assert drift == fj("after pschur", H, Z, verbose=False)
    assert drift < 1e-13
    Zbad = Z.copy()
    Zbad[0, 0, 0] += 1e-3
    bad = fc("corrupt", H, torch.tensor(Zbad), verbose=False)
    assert bad == fj("corrupt", H, Zbad, verbose=False) and bad > 1e-5
    # a signed cycle, left orientation
    G = pt.pschur(torch.tensor(A), "L", S=(True, False, True))
    fg = pt.FacChecker(A, S=(True, False, True), left=True)
    dg = fg("signed", G.Ts, G.Zs, verbose=False)
    assert dg == psd.FacChecker(A, S=(True, False, True), left=True)(
        "signed", G.Ts.numpy(), G.Zs.numpy(), verbose=False)
    assert dg < 1e-12


def _graded_cycle(rng, p, n, grade=6.0, cplx=False):
    A = rng.standard_normal((p, n, n))
    if cplx:
        A = A + 1j * rng.standard_normal((p, n, n))
    g = np.logspace(0, grade, n)
    for l in range(p):
        A[l] = A[l] * g[None, :] / g[:, None]
    return A


@pytest.mark.parametrize("seed,p,n,grade,cplx", [(3, 4, 10, 6.0, False), (5, 3, 12, 8.0, False),
                                                 (11, 1, 8, 7.0, False), (11, 4, 8, 7.0, False),
                                                 (13, 3, 9, 5.0, True)])
def test_balance_matches_jax_bit_for_bit(seed, p, n, grade, cplx):
    A = _graded_cycle(np.random.default_rng(seed), p, n, grade, cplx)
    Ab, D = pt.balance_pcycle(torch.tensor(A))
    Aj, Dj = jax_balance(A)
    assert Ab.device.type == "cpu" and D.device.type == "cpu"
    assert Ab.numpy().tobytes() == Aj.tobytes() and Ab.dtype == torch.from_numpy(Aj).dtype
    assert D.numpy().tobytes() == Dj.tobytes()
    Ab2, _ = pt.balance_pcycle(A, device="cpu")
    assert torch.equal(Ab, Ab2)


@pytest.mark.parametrize("cplx,shifted", [(False, True), (False, False), (True, True)])
def test_eigvecs_partial_matches_jax(cplx, shifted):
    p, n, nev = (2, 24, 3) if cplx else (3, 30, 4)
    A = mkmats(np.random.default_rng(1234), p, n, cplx=cplx)
    pj, hj = jax_partial(A, nev, "LM", seed=3)
    k = hj.nconverged
    assert k >= 2
    P = partial_from_jax(pj)
    select = [True, False] + [True] * (k - 2)
    Vt = eigvecs_partial(P, select, shifted=shifted)
    Vj = jax_evp(pj, select, shifted=shifted)
    assert len(Vt) == len(Vj) == (p if shifted else 1)
    for a, b in zip(Vt, Vj):
        b = np.asarray(b)
        assert a.device.type == "cpu" and a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
