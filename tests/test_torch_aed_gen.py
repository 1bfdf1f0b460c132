"""Aggressive early deflation and the host-tail finish of the port's real
generalized ("rg": a real cycle with a signature S) and complex ("cx")
iterations (``ops/aed.py``, ``ops/pqz_real.py::pqz_real_gen_core_aed``,
``ops/pqz_complex.py::pqz_complex_core_aed``).

* ``aed_analyze_rg`` and ``aed_analyze_cx`` against the JAX package's on
  the same windows (p=3, S=(T,F,T)): a tiny coupling deflates the whole
  window, a generic window deflates nothing (None), a planted converged
  trailing block deflates partly.  ``d`` is equal; Wfinal, Ztot and the
  values agree within 1e-12 relative, or within ten times the JAX
  re-reduction's own relative spread under a 1e-16 relative perturbation
  of its input where that is larger, once Ztot's columns are turned to the
  JAX package's phases (``aligned``: the port re-reduces the leading u x u
  problem alone, the JAX package embeds it in the full window, and the RQ
  of an inverted factor then fixes the signs of its Hessenberg form
  otherwise).  Both window Schurs are the repo's native C++ ones; the
  re-reductions differ by rounding, which the signed reduction's Givens
  chains amplify: on the complex planted window the two packages differ by
  more than 1e-12 relative, but by less than ten times what the JAX
  re-reduction alone moves under that perturbation.
* ``aed_apply`` against the transform written out in numpy, float64 and
  complex128, with a mixed signature, exact zeros left of and below the
  window.
* the drivers at the sizes of ``tests/test_aed.py``'s chunked cases: rg
  p=3 n=36 S=(T,F,T) and cx p=2 n=36 S=(T,F), ``AlgoConfig(aed_window=10,
  aed_interval=8)``: AED fires, the reconstruction holds within
  1e-11 n max|A| and the eigenvalues lie within 1e-8 of the port's
  AED-off core; ``host_tail=10`` finishes the leading window (in segments
  of 8 iterations, as ``tests/test_host_tail.py``); with ``aed=False,
  host_tail=-1`` the drivers are bit for bit the direct cores.
* the pipelines take AED and the host tail by default, and record the
  tallies in ``last_info``.

Inputs come from ``numpy.random.default_rng(seed)``.  The JAX side compiles
two programs, each once: its signed reduction of the planted windows
(``phessenberg_signed_core`` at p=3 w=12, float64 and complex128), through
the module fixture ``jax_analyses``.
"""
import numpy as np
import pytest
import torch

import periodicschurdecompositions_jl_tpu  # noqa: F401  (enables x64)
from periodicschurdecompositions_jl_tpu.ops import aed as jaed
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch.config import AlgoConfig, default_config
from periodicschurdecompositions_jl_torch.ops import aed, pqz_complex, pqz_real
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_signed_core

EPS = float(np.finfo(np.float64).eps)
S3 = (True, False, True)
AED_CFG = AlgoConfig(aed_window=10, aed_interval=8)
OFF = AlgoConfig(aed=False, host_tail=-1)


def window(rng, p, w, cplx):
    def m():
        x = rng.standard_normal((w, w))
        return x + 1j * rng.standard_normal((w, w)) if cplx else x
    return np.stack([np.triu(m(), -1 if l == 0 else 0) for l in range(p)])


def schur_of(H, S, cplx):
    """The port's own core on a CPU tensor: the (p, k, k) Schur form."""
    if cplx:
        T, *_, ok = pqz_complex.pqz_complex_core(torch.tensor(H), S, want_z=False)
    else:
        T, *_, ok = pqz_real.pqz_real_gen_core(torch.tensor(H), S, want_z=False)
    assert ok
    return T.numpy()


def planted(seed, cplx, w=12, conv=5):
    """A window whose trailing conv block is decoupled and already in
    generalized periodic Schur form (``tests/test_aed.py``'s partial case)."""
    rng = np.random.default_rng(seed)
    Hwin = window(rng, 3, w, cplx)
    Hwin[:, w - conv:, w - conv:] = schur_of(window(rng, 3, conv, cplx), S3, cplx)
    Hwin[0][w - conv, w - conv - 1] = 0.0
    return Hwin


WINDOWS = {
    "tiny-coupling": lambda c: (window(np.random.default_rng(11), 3, 10, c), 1e-25),
    "generic": lambda c: (window(np.random.default_rng(16), 3, 12, c), 1.7),
    "partial": lambda c: (planted(13, c), 0.9),
}
ROUTES = {"rg": False, "cx": True}


def values_of(res, cplx):
    """(d, Wf, Zt, eigenvalues, beta, spike) of either analysis."""
    if cplx:
        d, Wf, Zt, al, be, sc, sph = res
    else:
        d, Wf, Zt, ar, ai, be, sc, sph = res
        al = np.asarray(ar) + 1j * np.asarray(ai)
    be, sc = np.asarray(be), np.asarray(sc)
    return d, Wf, Zt, np.asarray(al) / be * np.exp2(sc.astype(float)), be, sph


def aligned(res, ref, cplx):
    """``res`` with its window transforms' columns turned to the phases of
    ``ref``'s: the leading window's periodic Hessenberg form is unique up to
    one diagonal unitary D[l] per factor (Q[0] e1 fixed; the implicit-Q
    theorem), and the port, which re-reduces the leading u x u problem
    alone, fixes those signs otherwise than the JAX package, which embeds
    it in the full window.  Zt[l] -> Zt[l] D[l]^H, and Wf[l] -> D[l] Wf[l]
    D[l+1]^H (direct) or D[l+1] Wf[l] D[l]^H (inverted)."""
    d, Wf, Zt = res[:3]
    Ztj = np.asarray(ref[2])
    dots = np.einsum("lij,lij->lj", np.conj(Ztj), Zt)
    D = dots / np.abs(dots)
    if not cplx:
        D = D.real
    p = Zt.shape[0]
    Zt = Zt * np.conj(D)[:, None, :]
    Wf = np.stack([(D[l][:, None] * Wf[l] * np.conj(D[(l + 1) % p])[None, :]) if S3[l]
                   else (D[(l + 1) % p][:, None] * Wf[l] * np.conj(D[l])[None, :])
                   for l in range(p)])
    return (d, Wf, Zt) + tuple(res[3:])


def spread(res, ref, cplx):
    """Largest relative difference of Wf, Zt, the values and the spike."""
    a, b = values_of(res, cplx), values_of(ref, cplx)
    return max(np.abs(x - np.asarray(y)).max() / max(np.abs(y).max(), 1.0)
               for x, y in zip(a[1:4] + a[5:], b[1:4] + b[5:]))


def analyze_jax(fn, Hwin, beta, tol):
    """The JAX analysis, and its re-reduction's own relative spread under a
    1e-16 relative perturbation of the reduction's input (0 when the
    window takes no re-reduction)."""
    seen = []
    reduce = jaed._phess_window_signed

    def spy(Aw, S):
        seen.append(Aw.copy())
        return reduce(Aw, S)
    jaed._phess_window_signed = spy
    try:
        ref = fn(Hwin.copy(), S3, beta, tol)
    finally:
        jaed._phess_window_signed = reduce
    sens = 0.0
    for Aw in seen:
        H, Q = reduce(Aw, S3)
        noise = np.random.default_rng(99).standard_normal(Aw.shape)
        Hp, Qp = reduce(Aw * (1 + 1e-16 * noise), S3)
        sens = max(sens, np.abs(Hp - H).max() / np.abs(H).max(), np.abs(Qp - Q).max())
    return ref, sens


@pytest.fixture(scope="module")
def jax_analyses():
    out = {}
    for route, cplx in ROUTES.items():
        fn = jaed.aed_analyze_cx if cplx else jaed.aed_analyze_rg
        for case, make in WINDOWS.items():
            Hwin, beta = make(cplx)
            w = Hwin.shape[-1]
            tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
            out[route, case] = (Hwin, beta, tol) + analyze_jax(fn, Hwin, beta, tol)
    return out


@pytest.mark.parametrize("case", sorted(WINDOWS))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_analyze_matches_jax(jax_analyses, route, case):
    cplx = ROUTES[route]
    Hwin, beta, tol, ref, sens = jax_analyses[route, case]
    fn = aed.aed_analyze_cx if cplx else aed.aed_analyze_rg
    res = fn(Hwin.copy(), S3, beta, tol)
    if case == "generic":
        assert res is None and ref is None
        return
    assert res is not None and ref is not None
    w = Hwin.shape[-1]
    d, Wf, Zt, vals, be, sph = values_of(res, cplx)
    dj, Wfj, Ztj, valsj, bej, sphj = values_of(ref, cplx)
    assert d == dj
    assert d == w if case == "tiny-coupling" else 5 <= d < w
    assert np.array_equal(be, bej)
    for x, y in ((Wf, Wfj), (Zt, Ztj), (vals, valsj), (sph, sphj)):
        y = np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
    assert spread(aligned(res, ref, cplx), ref, cplx) <= max(1e-12, 10 * sens)
    u = w - d
    assert np.all(Wf[:, u:, :u] == 0.0) and np.all(sph[1:] == 0.0)
    for l in range(3):
        ln = (l + 1) % 3
        assert np.abs(Zt[l] @ Zt[l].conj().T - np.eye(w)).max() < 100 * EPS * w
        R = (Zt[l].conj().T @ Hwin[l] @ Zt[ln] if S3[l]
             else Zt[ln].conj().T @ Hwin[l] @ Zt[l])
        assert np.abs(R - Wf[l]).max() < 1e3 * EPS * np.abs(Hwin[l]).max() + 2 * tol


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_apply_matches_numpy(route):
    cplx = ROUTES[route]
    rng = np.random.default_rng(4)
    p, n, w, s = 3, 16, 6, 7
    H = window(rng, p, n, cplx)
    H[0][s + w, s + w - 1] = 0.0  # rows below the window are deflated

    def unitary(k):
        M = rng.standard_normal((k, k))
        return np.linalg.qr(M + 1j * rng.standard_normal((k, k)) if cplx else M)[0]

    Z = np.stack([unitary(n) for _ in range(p)])
    Zt = np.stack([unitary(w) for _ in range(p)])
    Wf = window(rng, p, w, cplx)
    sph = np.zeros(w, H.dtype)
    sph[0] = 0.5
    Hp, Zp = torch.tensor(H), torch.tensor(Z)
    aed.aed_apply(Hp, Zp, s, torch.tensor(Zt), torch.tensor(Wf), torch.tensor(sph), S3)
    V = np.stack([np.eye(n, dtype=H.dtype) for _ in range(p)])
    V[:, s:s + w, s:s + w] = Zt
    for l in range(p):
        ln = (l + 1) % p
        ref = (V[l].conj().T @ H[l] @ V[ln] if S3[l]
               else V[ln].conj().T @ H[l] @ V[l])
        ref[s:s + w, s:s + w] = Wf[l]
        if l == 0:
            ref[s:s + w, s - 1] = sph
        assert np.abs(Hp[l].numpy() - ref).max() <= 1e-13
        assert np.abs(Zp[l].numpy() - Z[l] @ V[l]).max() <= 1e-13
        # exact zeros stay exact: left of the window's rows, below it
        lo = s - 1 if l == 0 else s
        assert torch.all(Hp[l, s:s + w, :lo] == 0) and torch.all(Hp[l, s + w:, s:s + w] == 0)
        assert torch.equal(Hp[l, s + w:, :], torch.tensor(H[l, s + w:, :]))


DRIVES = {"rg": (S3, 36, False), "cx": ((True, False), 36, True)}


def core(route, H, Q, cfg=None, **kw):
    """The direct core (cfg None) or the AED driver; returns (T, Z, values,
    fields, info)."""
    S, _, cplx = DRIVES[route]
    if cplx:
        fn = pqz_complex.pqz_complex_core if cfg is None else pqz_complex.pqz_complex_core_aed
    else:
        fn = pqz_real.pqz_real_gen_core if cfg is None else pqz_real.pqz_real_gen_core_aed
    out = fn(H, S, Z=Q, with_info=True, **({} if cfg is None else {"cfg": cfg}), **kw)
    fields = [np.asarray(x) for x in out[2:-2]]
    if cplx:
        vals = fields[0] / fields[1] * np.exp2(fields[2].astype(float))
    else:
        vals = (fields[0] + 1j * fields[1]) / fields[2] * np.exp2(fields[3].astype(float))
    assert out[-2]
    return out[0], out[1], vals, fields, out[-1]


@pytest.fixture(scope="module", params=sorted(DRIVES))
def drive(request):
    route = request.param
    S, n, cplx = DRIVES[route]
    rng = np.random.default_rng(20 + n)
    A = rng.standard_normal((len(S), n, n))
    if cplx:
        A = A + 1j * rng.standard_normal(A.shape)
    H, Q = phessenberg_signed_core(torch.tensor(A), S)
    return route, A, H, Q, core(route, H, Q)


def reconstruct_ok(route, A, T, Z):
    S = DRIVES[route][0]
    T, Z = T.numpy(), Z.numpy()
    p, n = A.shape[0], A.shape[-1]
    for l in range(p):
        ln = (l + 1) % p
        Ax = (Z[l] @ T[l] @ Z[ln].conj().T if S[l] else Z[ln] @ T[l] @ Z[l].conj().T)
        assert np.abs(Ax - A[l]).max() < 1e-11 * n * np.abs(A).max(), l


def near(vals, ref):
    d = np.abs(vals[:, None] - ref[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max()) < 1e-8 * max(1.0, np.abs(ref).max())


def test_driver_deflates_by_aed(drive):
    route, A, H, Q, off = drive
    d0 = aed.stats["deflated"]
    T, Z, vals, _, info = core(route, H, Q, AED_CFG)
    assert info["aed_deflated"] > 0 and info["aed_hits"] > 0
    assert info["aed_events"] >= info["aed_hits"] and info["aed_s"] > 0
    assert aed.stats["deflated"] - d0 == info["aed_deflated"] + info["host_tail_finished"]
    assert info["niter"] < off[4]["niter"]
    reconstruct_ok(route, A, T, Z)
    assert near(vals, off[2])


def test_driver_host_tail_finishes(drive):
    # segments of 8 iterations, as tests/test_host_tail.py's chunk_iters
    route, A, H, Q, off = drive
    T, Z, vals, _, info = core(route, H, Q, AlgoConfig(aed=False, host_tail=10),
                               chunk_iters=8)
    assert 2 <= info["host_tail_finished"] <= 10
    reconstruct_ok(route, A, T, Z)
    assert near(vals, off[2])


def test_driver_off_is_the_direct_core(drive):
    route, A, H, Q, off = drive
    T, Z, vals, fields, info = core(route, H, Q, OFF)
    assert torch.equal(T, off[0]) and torch.equal(Z, off[1])
    assert all(np.array_equal(a, b) for a, b in zip(fields, off[3]))
    assert info["niter"] == off[4]["niter"]
    assert info["aed_events"] == info["host_tail_finished"] == 0


def test_default_schedule():
    # the JAX drivers' gates: AED from aed_min_n = 192, the tail min(64, n // 8)
    assert aed.aed_schedule(default_config, 256, interval_div=6) == (25, 42, True, 32)
    assert aed.aed_schedule(default_config, 128, interval_div=6)[2:] == (False, 16)
    assert aed.aed_schedule(OFF, 256, interval_div=6)[2:] == (False, 0)
    assert aed.signed_chunk_iters(8, 256) == 256


@pytest.mark.parametrize("route", sorted(DRIVES))
def test_pipeline_records_the_tallies(route):
    S, _, cplx = DRIVES[route]
    rng = np.random.default_rng(5)
    A = rng.standard_normal((len(S), 24, 24))
    if cplx:
        A = A + 1j * rng.standard_normal(A.shape)
        P = pqz_complex.pschur_complex_pipeline(torch.tensor(A), S, "R", cfg=AlgoConfig(
            aed_window=8, aed_interval=6))
        info = pqz_complex.last_info
    else:
        P = pqz_real.pschur_real_gen_pipeline(torch.tensor(A), S, "L", cfg=AlgoConfig(
            aed_window=8, aed_interval=6))
        info = pqz_real.last_info
    assert info["converged"] and info["aed_events"] > 0
    for k in ("aed_deflated", "host_tail_finished", "aed_hits", "aed_s"):
        assert k in info
    ok, rep = pt.check_psd(P, A, tol=100.0)
    assert ok, rep
