"""Aggressive early deflation and the host-tail finish of the port
(``ops/aed.py``, ``native.py``, ``ops/pqr_real.py::pqr_real_core_aed``).

* ``aed_analyze`` against the JAX package's on the same windows (the cases
  of ``tests/test_aed.py``): a tiny coupling deflates the whole window, a
  generic window deflates nothing (None), a planted converged trailing
  block deflates partly.  ``d`` is equal; Wfinal, Ztot and the values agree
  within 1e-12 relative (both window Schurs are the repo's native C++ one;
  the re-reductions differ by rounding).
* the invariants of ``tests/test_aed.py``'s randomized stress on five
  windows (half with a planted converged block): orthogonal transforms,
  reconstruction up to the spike tolerance, deflated eigenvalues from the
  window product's spectrum, the structure of Wfinal and the spike.
* ``aed_apply`` against the transform written out in numpy, with exact
  zeros left of and below the window.
* the driver on the CPU at p=3 n=40 with ``AlgoConfig(aed_window=12,
  aed_interval=8)``: AED deflates, the eigenvalues lie within 1e-10
  relative of ``eigvals(prod(A))`` and of the JAX ``pqr_real_core``, and
  ``check_psd`` holds with orthonormality 10 eps n (as
  ``tests/test_torch_pschur.py``) and residual 32 eps (the reference's
  contract); the same with two bulges, at residual 40 eps; with
  ``host_tail=10`` the host tail finishes the leading window (at most 10
  rows).  With the correctly rounded CPU square root under the reflectors
  and rotations (``ops/rotations.py::sqrt_rn``; torch's is one ulp off
  for ~0.7% of arguments) the driver reads (``python3
  scripts/cpu_core_checks.py residuals``), at this file's seed 70, 24.4
  eps (one bulge), 33.5 (two) and 22.8 (``host_tail=10``); on seeds 0-3
  24.9-30.5 eps with one bulge and the tail, 22.4-28.3 with two.  (With
  torch's square root: 32.8, 29.5 and 33.3 at seed 70.)
* the graded-band stall (``tests/test_pqr_ff.py::
  test_stagnation_relaxation_converges``): p=2 n=10 with ``at_pwr16=12``,
  which rejects nearly every product-level deflation, converges through
  the stagnation relaxation.
* ``pqr_real_core`` called directly runs no AED, whatever the config
  says: bit for bit the driver with ``aed=False, host_tail=-1`` (which
  runs neither), on a draw where the driver's AED fires.
* a failed native build raises, and so does a driver that needs it; two
  threads loading the library for the first time build it once.

Inputs come from ``numpy.random.default_rng(seed)``.  The JAX side compiles
two programs: its ``phessenberg_core`` at (3, 12) and ``pqr_real_core`` at
(3, 40).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from periodicschurdecompositions_jl_tpu.ops.aed import aed_analyze as jaed
from periodicschurdecompositions_jl_tpu.ops.pqr_real import pqr_real_core as jcore
import periodicschurdecompositions_jl_torch as pt
from periodicschurdecompositions_jl_torch import native
from periodicschurdecompositions_jl_torch.config import AlgoConfig
from periodicschurdecompositions_jl_torch.ops import aed, pqr_real
from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_core

EPS = float(np.finfo(np.float64).eps)
P_DRV, N_DRV = 3, 40
AED_CFG = AlgoConfig(aed_window=8, aed_interval=6)


def window(rng, p, w):
    return np.stack([np.triu(rng.standard_normal((w, w)), -1 if l == 0 else 0)
                     for l in range(p)])


def planted(seed, p=3, w=12, conv=5):
    """A window whose trailing conv block is decoupled and already in
    periodic Schur form (``tests/test_aed.py``'s partial case)."""
    rng = np.random.default_rng(seed)
    Hwin = window(rng, p, w)
    T, _, _, _, ok = pqr_real.pqr_real_core(torch.tensor(window(rng, p, conv)),
                                            want_z=False)
    assert ok
    Hwin[:, w - conv:, w - conv:] = T.numpy()
    Hwin[0][w - conv, w - conv - 1] = 0.0
    return Hwin


WINDOWS = {
    "tiny-coupling": lambda: (window(np.random.default_rng(1), 3, 10), 1e-25),
    "generic": lambda: (window(np.random.default_rng(2), 2, 12), 1.7),
    "partial": lambda: (planted(3), 0.9),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_analyze_matches_jax(case):
    Hwin, beta = WINDOWS[case]()
    w = Hwin.shape[-1]
    tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
    res = aed.aed_analyze(Hwin.copy(), beta, tol)
    ref = jaed(Hwin.copy(), beta, tol)
    if case == "generic":
        assert res is None and ref is None
        return
    assert res is not None and ref is not None
    d, Wf, Zt, vals, sph = res
    dj, Wfj, Ztj, valsj, sphj = ref
    assert d == dj
    assert d == w if case == "tiny-coupling" else 5 <= d < w
    for x, y in ((Wf, Wfj), (Zt, Ztj), (vals, valsj), (sph, sphj)):
        y = np.asarray(y)
        assert x.shape == y.shape
        assert np.abs(x - y).max() <= 1e-12 * max(np.abs(y).max(), 1.0)
    u = w - d
    assert np.all(Wf[:, u:, :u] == 0.0) and np.all(sph[1:] == 0.0)
    for l in range(Hwin.shape[0]):
        assert np.abs(Zt[l] @ Zt[l].T - np.eye(w)).max() < 100 * EPS * w


@pytest.mark.parametrize("seed", range(5))
def test_analyze_invariants(seed):
    # tests/test_aed.py's randomized stress, on the port alone: whatever the
    # analysis decides, its transforms are orthogonal, reconstruct the
    # window up to the spike tolerance, and deflate eigenvalues of the
    # window product's spectrum; the leading part is periodic Hessenberg
    rng = np.random.default_rng(1000 + seed)
    p, w = 3, 10
    Hwin = window(rng, p, w)
    if seed % 2 == 0:
        conv = 4
        T, _, _, _, ok = pqr_real.pqr_real_core(torch.tensor(window(rng, p, conv)),
                                                want_z=False)
        assert ok
        Hwin[:, w - conv:, w - conv:] = T.numpy()
        Hwin[0][w - conv, w - conv - 1] = 0.0
    beta = float(rng.standard_normal())
    tol = EPS * w * np.abs(Hwin[0]).sum(axis=0).max()
    res = aed.aed_analyze(Hwin, beta, tol)
    if seed % 2 == 0:
        assert res is not None
    if res is None:
        return
    d, Wf, Zt, vals, sph = res
    u = w - d
    w_ref = np.linalg.eigvals(np.linalg.multi_dot(list(Hwin)))
    scale = max(np.abs(w_ref).max(), 1.0)
    for l in range(p):
        assert np.abs(Zt[l] @ Zt[l].T - np.eye(w)).max() < 1e3 * EPS
        R = Zt[l].T @ Hwin[l] @ Zt[(l + 1) % p]
        assert np.abs(R - Wf[l]).max() < 1e3 * EPS * max(1.0, np.abs(Hwin[l]).max()) + 2 * tol
    for v in vals[u:]:
        assert min(abs(v - z) for z in w_ref) < 1e6 * EPS * scale
    assert np.all(sph[1:] == 0.0)
    assert np.all(np.tril(Wf[0][:u, :u], -2) == 0.0)
    for l in range(1, p):
        assert np.all(np.tril(Wf[l], -1) == 0.0)


def test_apply_matches_numpy():
    rng = np.random.default_rng(4)
    p, n, w, s = 3, 16, 6, 7
    N = n + 1
    H = np.zeros((p, N, N))
    H[:, :n, :n] = window(rng, p, n)
    H[0][s + w, s + w - 1] = 0.0  # rows below the window are deflated
    Z = np.zeros((p, N, N))
    Z[:, :n, :n] = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0]
                             for _ in range(p)])
    Zt = np.stack([np.linalg.qr(rng.standard_normal((w, w)))[0] for _ in range(p)])
    Wf = window(rng, p, w)
    sph = np.zeros(w)
    sph[0] = 0.5
    Hp, Zp = torch.tensor(H), torch.tensor(Z)
    aed.aed_apply(Hp, Zp, s, torch.tensor(Zt), torch.tensor(Wf), torch.tensor(sph))
    V = np.stack([np.eye(N) for _ in range(p)])
    V[:, s:s + w, s:s + w] = Zt
    for l in range(p):
        ref = V[l].T @ H[l] @ V[(l + 1) % p]
        ref[s:s + w, s:s + w] = Wf[l]
        if l == 0:
            ref[s:s + w, s - 1] = sph
        assert np.abs(Hp[l].numpy() - ref).max() <= 1e-13
        assert np.abs(Zp[l].numpy() - Z[l] @ V[l]).max() <= 1e-13
        # exact zeros stay exact: left of the window's rows, below it
        lo = s - 1 if l == 0 else s
        assert torch.all(Hp[l, s:s + w, :lo] == 0) and torch.all(Hp[l, s + w:, s:s + w] == 0)
        assert torch.equal(Hp[l, s + w:, :], torch.tensor(H[l, s + w:, :]))


@pytest.fixture(scope="module")
def drive():
    A = np.random.default_rng(P_DRV * 10 + N_DRV).standard_normal((P_DRV, N_DRV, N_DRV))
    H, Q = phessenberg_core(torch.tensor(A))
    T, _, wr, wi, ok = jcore(jnp.asarray(H.numpy()), Z=jnp.asarray(Q.numpy()), want_z=False)
    assert bool(ok)
    return A, H, Q, np.asarray(wr) + 1j * np.asarray(wi)


def run_checked(drive, cfg, tol=32.0):
    A, H, Q, wj = drive
    T, Z, wr, wi, ok, info = pqr_real.pqr_real_core_aed(H, Z=Q, cfg=cfg, with_info=True)
    assert ok
    w = np.sort_complex(wr + 1j * wi)
    wref = np.sort_complex(np.linalg.eigvals(np.linalg.multi_dot(list(A))))
    assert np.abs(w - wref).max() <= 1e-10 * np.abs(wref).max()
    assert np.abs(w - np.sort_complex(wj)).max() <= 1e-10 * np.abs(wj).max()
    P = pt.PeriodicSchur(Ts=T, Zs=Z, values=torch.complex(torch.tensor(wr),
                                                          torch.tensor(wi)))
    okc, rep = pt.check_psd(P, A, qtol=10.0, tol=tol)
    assert okc, rep
    return info


@pytest.mark.parametrize("nbulges", [1, 2])
def test_driver_deflates_by_aed(drive, nbulges):
    d0 = aed.stats["deflated"]
    info = run_checked(drive, AlgoConfig(aed_window=12, aed_interval=8, nbulges=nbulges),
                       tol=32.0 if nbulges == 1 else 40.0)
    assert info["aed_deflated"] > 0 and info["aed_hits"] > 0
    assert info["aed_events"] >= info["aed_hits"] and info["aed_s"] > 0
    assert aed.stats["deflated"] - d0 == info["aed_deflated"] + info["host_tail_finished"]


def test_driver_host_tail_finishes(drive):
    info = run_checked(drive, AlgoConfig(aed_window=12, aed_interval=8, host_tail=10))
    assert 2 <= info["host_tail_finished"] <= 10


def test_stagnation_relaxation_converges():
    """With the Ahues-Tisseur tightening at at_pwr16=12 (threshold ~ulp^1.75)
    the stagnation relaxation must still drive the iteration to
    convergence (the graded-band stall class; JAX
    ``tests/test_pqr_ff.py::test_stagnation_relaxation_converges``)."""
    p, n = 2, 10
    A = np.random.default_rng(33).standard_normal((p, n, n))
    H, Q = phessenberg_core(torch.tensor(A))
    T, Z, _, _, ok = pqr_real.pqr_real_core_aed(
        H, Z=Q, maxitfac=40, cfg=AlgoConfig(at_pwr16=12, host_tail=-1))
    assert ok, "the relaxation failed to rescue the tightened test"
    T, Z = T.numpy(), Z.numpy()
    for l in range(p):
        R = Z[l] @ T[l] @ Z[(l + 1) % p].T - A[l]
        assert np.abs(R).max() / np.abs(A).max() < 1e-12, l


def test_direct_core_runs_no_aed():
    H, Q = phessenberg_core(torch.tensor(
        np.random.default_rng(7).standard_normal((2, 20, 20))))
    off = pqr_real.pqr_real_core_aed(H, Z=Q, cfg=AlgoConfig(aed=False, host_tail=-1),
                                     with_info=True)
    assert pqr_real.pqr_real_core_aed(H, Z=Q, cfg=AED_CFG, with_info=True)[5]["aed_events"] > 0
    out = pqr_real.pqr_real_core(H, Z=Q, cfg=AED_CFG, with_info=True)
    assert torch.equal(out[0], off[0]) and torch.equal(out[1], off[1])
    assert np.array_equal(out[2], off[2]) and np.array_equal(out[3], off[3])
    assert out[5]["niter"] == off[5]["niter"]
    assert off[5]["aed_events"] == off[5]["host_tail_finished"] == 0


def test_pipeline_records_the_tallies():
    A = torch.tensor(np.random.default_rng(5).standard_normal((2, 24, 24)))
    P = pqr_real.pschur_real_pipeline(A, "L", cfg=AlgoConfig(aed_window=8, aed_interval=6))
    info = pqr_real.last_info
    assert info["converged"] and info["aed_events"] > 0
    for k in ("aed_deflated", "host_tail_finished", "aed_hits", "aed_s"):
        assert k in info
    ok, rep = pt.check_psd(P, A.numpy(), tol=100.0)
    assert ok, rep


def test_failed_native_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int pschur_real_cpu( {\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ build of .*broken.cpp failed"):
        native.load()
    assert native._lib is None
    H = torch.tensor(window(np.random.default_rng(6), 2, 24))
    with pytest.raises(RuntimeError, match="g\\+\\+ build"):
        pqr_real.pqr_real_core_aed(H, cfg=AlgoConfig(aed_window=8))


def test_native_load_two_threads_build_once(monkeypatch, tmp_path):
    """Two threads loading the library for the first time together build it
    once and load the same finished file; no temporary file is left."""
    import subprocess
    import threading
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int pschur_real_cpu(int, int, double *, double *, '
                   'double *, double *, int, int) { return 0; }\n')
    build = tmp_path / "build"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "_BUILD", build)
    runs = []
    real_run = subprocess.run

    def counted(*a, **k):
        runs.append(a)
        return real_run(*a, **k)

    monkeypatch.setattr(native.subprocess, "run", counted)
    start = threading.Barrier(2)
    libs, errors = [], []

    def worker():
        start.wait()
        try:
            libs.append(native.load())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(libs) == 2 and libs[0] is libs[1]
    assert len(runs) == 1
    assert [f.suffix for f in build.iterdir()] == [".so"]
