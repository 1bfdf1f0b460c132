#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Builds the CUDA kernels of ``periodicschurdecompositions_jl_torch/csrc``,
checks each kernel against its plain torch version on the card at the
shapes of its path, then drives the paths through the public entry points
and checks the results:

* the Hessenberg reduction kernel (one cooperative launch), float64 on the
  headline draw (p=16, n=512) and at p=1 n=64 and p=3 n=101, complex128 on
  the complex leg's draw (p=8, n=256), at the same small shapes and on a
  cycle of zero tails with complex diagonals;
* the signed reduction's stage-2 kernel (one launch), float64 on the rg
  leg's draw (p=8, n=256, alternating S) and complex128 on the signed
  complex leg's draw (p=8, n=128, alternating S), and both at small edge
  shapes (n=3, n=37 with S=(T,F,F), p=4 n=64 alternating, all direct,
  p=1, a planted zero on an inverted factor's diagonal);
* real: the kernels of the double-shift sweep, of the multi-bulge sweep
  (4 bulges) and of the 2x2 deflation at p=16, n=512; the headline draw
  through ``pschur_real_pipeline(A, 'R', cfg=AlgoConfig(aed=False,
  host_tail=-1))`` (the iteration without aggressive early deflation and
  the host tail), kernel G against its plain version on states of that
  leg's iteration (and its time alone, through ``glue_cuda`` and as one
  call of ``glue_products_scan_shift`` with the read-back and unpacking);
  ``pschur(A, 'R')`` on the same draw, the default main path (AED and the
  host tail, which must both deflate; eigenvalues against the AED-off
  leg's); ``ordschur`` and ``eigvecs`` of a p=4 n=64 decomposition on the
  card; the headline draw with ``nbulges=4`` (AED off; eigenvalues against
  the one-bulge leg's), and one 'L' problem with one and with two bulges;
* complex: the kernels of the single-shift QZ sweep and its shift at p=8,
  n=256 with an alternating signature; a complex p=8 n=256 cycle (no
  signature: the complex128 reduction kernel) through
  ``pschur_complex_pipeline(..., cfg=AlgoConfig(aed=False, host_tail=-1))``
  and a profile of that iteration, then through ``pschur`` (the default:
  aggressive early deflation and the host tail, each window re-reduced by
  the signed reduction's complex128 stage-2 kernel; AED must deflate and
  the eigenvalues agree with the AED-off leg's) and its profile; ``pschur``
  on a p=8 n=128 cycle with an alternating signature, and a small signed
  cycle against numpy's eigenvalues;
* real generalized: the kernels of the double-shift chase (rg A, B0, B) and
  the rotation ladders (R) at p=8, n=256 with an alternating signature;
  the p=8 n=256 draw of seed 4242 (the source configuration:
  benchmarks/probe_real_gen_ff.py) through ``pschur_real_gen_pipeline(...,
  cfg=AlgoConfig(aed=False, host_tail=-1))``, with each of its CZSHIFT
  launches held against the plain version on a CPU copy of its input
  (``rg_czshift_check``), then through ``pschur(A, 'R', S)`` (the default:
  AED and the host tail; AED must deflate, the eigenvalues agree with the
  AED-off leg's, and hess_signed launch once for the cycle and once for
  each window re-reduction), profiles of both iterations, and a small real
  ``gpschur`` against numpy's eigenvalues;
* the deflation actions (csrc/pqz_deflate.cu: CZSHIFT, DEFLATE_POS,
  DEFLATE_NEG down and up), float64 on the rg leg's reduction (p=8, n=256)
  and complex128 on the signed complex leg's (p=8, n=128, and its leading
  n=127 block), against their plain versions; and the singular leg:
  ``pschur(A, 'R', S)`` on real p=8 n=256 and complex p=8 n=127 cycles
  whose reduction keeps exact zeros planted on a direct and an inverted
  factor's diagonals (``singular_cycle``), which takes DEFLATE_POS and
  DEFLATE_NEG.

* want_t=False (the eigenvalues-only mode): B0 and B of the three routes
  and D with the window bound (``*_bounded`` C entries; rlo odd and off the
  tiles' grid) against their unbounded launches on the same input (bit for
  bit inside the window, untouched outside, Z bit for bit, ``bounded_ok``)
  and against the bounded plain versions, in each kernel phase; then
  ``pschur(..., want_t=False)`` on the headline draw (with Z and without),
  the complex leg's and the rg leg's, each against the same call with T:
  niter, AED tallies, launches, eigenvalues and Z bit for bit
  (``want_t_legs``).

* periodic Krylov-Schur (``partial_pschur``; no kernel of its own: the
  operator applications and their Gram-Schmidt are torch products on the
  card, the restart logic runs on the host): the JAX package's on-chip
  Krylov cell (p=4 n=256, nev=4, benchmarks/probe_krylov_chip.py's draw),
  the same construction at p=4 n=4096 made on the card, and the p=12
  N=10000 matrix-free operators of tests/test_krylov.py as callables on
  the card; each against the reference's result contract on the card and
  the construction's spectrum (``krylov_phase``).

* several problems and shards (``parallel/``; every shard on this one card,
  by explicit copies, the path two cards would take): the hostile rg draws
  of benchmarks/probe_rg_hostile.py's quick subset through ``pschur(A, 'R',
  S)`` (niter beside the native C++ core's); bench.py's throughput draw (8 x
  (p=8, n=128), seed 99) through ``ensemble_pschur_real_pipelined``
  sequentially and with two workers on their own streams (bit for bit,
  problems/min, idle share); ``batched_pschur_complex`` on 4 x (p=4, n=64)
  with an alternating S; the shard entries of B0 and B
  (``psd_sweep_left_shard``, ``psd_sweep_right_shard``) against the
  unsharded launches bit for bit with 1, 2 and 4 shards at p=16 n=512 and
  p=8 n=256, and against ``apply_log_shard_plain``; ``pschur_real_sharded``
  with two shards on a p=4 n=127 draw (bit for bit the one-card run without
  AED; its launches are the shard entries' in the kernels line); the ring
  and ``ShardedCycleOps`` on two shards against one card.

Each kernel's launch counter is set to 0 just before the path that runs it
and read just after.  Any failure raises (exit code != 0).

Output: the card's name and power limit, per-phase lines, a JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
P_HEAD, N_HEAD, SEED_HEAD = 16, 512, 12345
P_CX, N_CX, N_CX_SIGNED, SEED_CX = 8, 256, 128, 777
P_RG, N_RG, SEED_RG = 8, 256, 4242
MB_NB, MB_GAP = 4, 3  # the multi-bulge phase and headline leg: AlgoConfig(nbulges=4)
TOL = 1e-12  # kernel vs plain: max|dH| <= TOL * max|H|, max|dZ| <= TOL
# H100 SXM data sheet: HBM3 3.35 TB/s; FP64 34 TFLOP/s on the FP64 units and
# 67 TFLOP/s on the tensor cores (FP64 MMA).  An operation bound takes the
# higher peak: a blocked version of the same work runs mostly as matrix
# products, whatever the kernel here does.
HBM_BPS, FP64_FLOPS, FP64_MMA_FLOPS = 3.35e12, 34e12, 67e12


def _log(*a):
    print(*a, flush=True)


def mk_sweep_problem(p, n, rng):
    """Ghost-padded Hessenberg-triangular cycle, orthogonal Z, unit-1-norm v0.

    As tests/test_pallas_sweep.py::_mk_problem, except that the triangular
    factors' diagonals have modulus in [1, 2): with standard-normal
    diagonals the chase itself amplifies a 1e-16 relative input
    perturbation to ~1e-11 in H at n=512, so no two correct orderings of
    the arithmetic agree to 1e-12 there (sweep_phase prints the plain
    version's own sensitivity on the problem it uses)."""
    N = n + 1
    H = np.zeros((p, N, N))
    H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
        d = np.diagonal(H[f])[:n]
        np.fill_diagonal(H[f, :n, :n], np.where(d >= 0, 1.0, -1.0) * (1.0 + rng.random(n)))
    Z = np.zeros((p, N, N))
    for f in range(p):
        Z[f, :n, :n] = np.linalg.qr(rng.standard_normal((n, n)))[0]
    v0 = rng.standard_normal(3)
    v0 /= np.abs(v0).sum()
    return H, Z, v0


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FP64 operations over the card's FP64 peak (the tensor cores')."""
    tb, tf = nbytes / HBM_BPS, flops / max(FP64_FLOPS, FP64_MMA_FLOPS)
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def apply_bounds(p, n, m, i, nb=1):
    """Bounds of B0 (``sweep_left``) and B (``sweep_right``) with nb logs
    on the window [m, i] of a Hessenberg-triangular cycle, counting the
    entries that are not structural zeros.  B0 reads the upper parts of
    rows m..i (from column r-1 of H[0], column r of the other factors, up
    to column n-1) and the logs, and writes rows m..i from column m in
    full: its chained left transforms fill every entry below the
    (sub)diagonal (tests/test_torch_apply_schedule.py shows it), so its
    output is not banded.  Row i+1, column m-1 and the ghost column come
    out as they went in.  B reads and writes columns m..i of H's rows 0..i,
    full after B0, and of Z's rows 0..n-1 (B writes the zeros back), and
    reads the logs.  15 flops per entry triple and step."""
    K = i - m
    upper = sum(n - max(r - 1, m) for r in range(m, i + 1)) + \
        (p - 1) * sum(n - r for r in range(m, i + 1))
    logs = 8 * 9 * p * K * nb
    return {"sweep_left": bound(8 * upper + 8 * p * (i + 1 - m) * (n - m) + logs,
                                15 * p * (n - m) * K * nb),
            "sweep_right": bound(2 * 8 * p * (i + 1 + n) * (i + 1 - m) + logs,
                                 15 * p * (i + 1 + n) * K * nb)}


def cx_apply_bounds(p, n, m, i):
    """Bounds of the complex B0 (``qz_sweep_left``) and B
    (``qz_sweep_right``) on the window [m, i], complex128 (16 B), counting
    the entries that are not structural zeros.  B0 reads the upper parts of
    rows m..i of its columns >= m (from column r-1 of H[0], column r of the
    other factors) and the 4 L entries of each logged step, and writes rows
    m..i from column m in full (its chained left rotations fill the entries
    below the (sub)diagonal).  B reads and writes columns m..i of H's rows
    0..i and of Z's rows 0..n-1, and reads the 8 R and ZR entries of each
    step.  A complex 2x2 application is 28 flops per entry pair."""
    K = i - m
    upper = sum(n - max(r - 1, m) for r in range(m, i + 1)) + \
        (p - 1) * sum(n - r for r in range(m, i + 1))
    return {"qz_sweep_left": bound(16 * upper + 16 * p * (K + 1) * (n - m) + 16 * 4 * p * K,
                                   28 * p * (n - m) * K),
            "qz_sweep_right": bound(2 * 16 * p * (i + 1 + n) * (K + 1) + 16 * 8 * p * K,
                                    28 * p * (i + 1 + n) * K)}


def sha(t):
    """sha256 prefix of a tensor's bytes (equal: bit-identical)."""
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def structure_ok(H):
    Hn = H.cpu().numpy()
    return bool(np.all(np.tril(Hn[0], -2) == 0)
                and all(np.all(np.tril(Hn[f], -1) == 0) for f in range(1, Hn.shape[0])))


def random_logs(kind, p, n, m, i, rng, nb=1):
    """Random orthogonal (unitary) transform logs in the apply kernels'
    layouts, on the steps m..i-1 (rg: m..i-2): "real" (nb, p, n+1, 9),
    n the stack's size without its ghost line, the last step a 2x2 as
    kernel A's (so that line i+1 takes the identity); "cx" (p, n, 16) with
    L, R, ZR and the subdiagonal r; "rg" (p, n, 28) with L, R, ZR and r."""
    def orth(k, cplx=False):
        X = rng.standard_normal((k, k)) + (1j * rng.standard_normal((k, k)) if cplx else 0)
        return np.linalg.qr(X)[0]
    if kind == "real":
        R = np.zeros((nb, p, n + 1, 9))
        for b in range(nb):
            for f in range(p):
                for k in range(m, i):
                    F = np.eye(3)
                    if k == i - 1:
                        F[:2, :2] = orth(2)
                    else:
                        F = orth(3)
                    R[b, f, k] = F.reshape(9)
        return R
    if kind == "cx":
        L = np.zeros((p, n, 16), complex)
        for f in range(p):
            for k in range(m, i):
                L[f, k, :12] = np.concatenate([orth(2, True).reshape(4) for _ in range(3)])
                L[f, k, 12] = rng.standard_normal() + 1j * rng.standard_normal()
        return L
    L = np.zeros((p, n, 28))
    for f in range(p):
        for k in range(m, i - 1):
            L[f, k, :27] = np.concatenate([orth(3).reshape(9) for _ in range(3)])
            L[f, k, 27] = rng.standard_normal()
    return L


def bounded_ok(H0, Hu, Hb, rlo, chi, Zu=None, Zb=None):
    """A launch bounded to the want_t=False window against the unbounded
    one on the same input H0: inside the window (rows >= rlo, columns <
    chi) bit for bit the unbounded result, outside it H0 as it was; Z bit
    for bit the unbounded one's."""
    import torch
    r = torch.arange(H0.shape[-1], device=H0.device)
    inside = (r[:, None] >= rlo) & (r[None, :] < chi)
    return bool(torch.equal(Hb, torch.where(inside, Hu, H0))
                and (Zu is None or torch.equal(Zb, Zu)))


def event_ms(fn, reps):
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def wall_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def dev_us(e):
    """Device time of a profiler event, in microseconds."""
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def profile_line(prof, wall):
    """Wall clock, device busy time, idle share and the six kernels with the
    most device time of a profile.  Device-side events only: an operator's
    self device time would count its kernels twice."""
    ev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type) and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in ev) / 1e6
    top = sorted(ev, key=dev_us, reverse=True)[:6]
    return (f"wall {wall:.3f} s (profiler on), device busy {busy:.3f} s, idle share "
            f"{1 - busy / wall:.1%}; by kernel: "
            + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.1f} ms in {e.count}" for e in top))


def recon_err(H0, Z0, H, Z):
    """max_l max|Z H Z' - Z0 H0 Z0'| over the factors (backward error of a
    sweep, relative to max|H0|)."""
    p = H0.shape[0]
    worst = 0.0
    for l in range(p):
        ln = (l + 1) % p
        A = Z0[l] @ H0[l] @ Z0[ln].T
        B = Z[l] @ H[l] @ Z[ln].T
        worst = max(worst, float((A - B).abs().max()))
    return worst / float(H0.abs().max())


def sweep_phase(dev, p, n, report):
    """Kernels A -> B0 -> B against the plain versions on three windows.

    1. The whole sweep against chase_sweep_plain (the reference order).  A
       sweep is a chain of (i-m)*p dependent reflector generations, and the
       chain amplifies rounding: the plain version itself moves by ``sens``
       when its input is perturbed by a relative 1e-16.  Tolerance:
       max|dH| <= max(1e-12, 10 sens_H) max|H|, max|dZ| <= max(1e-12, 10 sens_Z).
    2. B0 and B against apply_log_plain on the SAME log (kernel A's): no
       generation chain, tolerance 1e-13 max|H| and 1e-13; B with Z == NULL
       leaves H bit for bit as with Z.
    3. The backward error of the kernel sweep, max|Z H Z' - Z0 H0 Z0'|
       <= 1e-13 max|H0|, and exact structural zeros.
    """
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, sweep
    rng = np.random.default_rng(2024)
    Hn, Zn, v0 = mk_sweep_problem(p, n, rng)
    N = n + 1
    windows = [(0, n - 1), (min(37, n - 3), min(300, n - 2)),
               (min(200, n - 4), min(202, n - 2)), (1, min(34, n - 2))]
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    err_a = err_b = 0.0
    times = {}
    for (m, i) in windows:
        H0 = torch.tensor(Hn, device=dev)
        if m > 0:
            H0[0, m, m - 1] = 0.0
        H0[0, i + 1, i] = 0.0
        Z0 = torch.tensor(Zn, device=dev)
        H0c = H0.clone()
        scale = float(H0.abs().max())
        Hk, Zk = H0.clone(), Z0.clone()
        sweep.chase_sweep(Hk, Zk, m, i, v0, want_z=True)
        Hp, Zp = H0.clone(), Z0.clone()
        t_plain = wall_ms(lambda: sweep.chase_sweep_plain(Hp, Zp, m, i, v0, want_z=True))
        pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
            Hn.shape), device=dev)
        Hq, Zq = H0 * pert, Z0.clone()
        sweep.chase_sweep_plain(Hq, Zq, m, i, v0, want_z=True)
        sens_h = float((Hq - Hp).abs().max()) / scale
        sens_z = float((Zq - Zp).abs().max())
        dh = float((Hk - Hp).abs().max()) / scale
        dz = float((Zk - Zp).abs().max())
        tol_h, tol_z = max(TOL, 10 * sens_h), max(TOL, 10 * sens_z)
        # 2. the apply kernels on kernel A's own log (A reads H0 only)
        R = sweep.sweep_generate(H0, m, i, v0)
        if not torch.equal(H0, H0c):
            raise AssertionError("kernel A wrote its input")
        Hb, Zb = H0.clone(), Z0.clone()
        _cuda.check(lib.psd_sweep_left(Hb.data_ptr(), R.data_ptr(), p, N, m, i, 1, st),
                    "sweep_left")
        _cuda.check(lib.psd_sweep_right(Hb.data_ptr(), Zb.data_ptr(), R.data_ptr(),
                                        p, N, m, i, 1, st), "sweep_right")
        # kernel B without Z (Z == NULL) leaves H as with Z
        Hnz = H0.clone()
        _cuda.check(lib.psd_sweep_left(Hnz.data_ptr(), R.data_ptr(), p, N, m, i, 1, st),
                    "sweep_left")
        _cuda.check(lib.psd_sweep_right(Hnz.data_ptr(), None, R.data_ptr(), p, N, m, i, 1,
                                        st), "sweep_right")
        if not torch.equal(Hnz, Hb):
            raise AssertionError(f"B with Z == NULL changed H on [{m}, {i}]")
        Ha, Za = H0.clone(), Z0.clone()
        t_apply = wall_ms(lambda: sweep.apply_log_plain(Ha, Za, R, m, i, want_z=True))
        db = max(float((Hb - Ha).abs().max()) / scale, float((Zb - Za).abs().max()))
        be_k = recon_err(H0, Z0, Hk, Zk)
        be_p = recon_err(H0, Z0, Hp, Zp)
        _log(f"sweep window [{m}, {i}]: vs chase_sweep_plain max|dH|/max|H| {dh:.3e} "
             f"max|dZ| {dz:.3e} (plain's own 1e-16 sensitivity {sens_h:.3e} / "
             f"{sens_z:.3e}; tolerance {tol_h:.3e} / {tol_z:.3e}); B0+B vs "
             f"apply_log_plain {db:.3e} (B with Z == NULL: H identical); backward error "
             f"kernel {be_k:.3e} plain {be_p:.3e}; plain sweep {t_plain:.1f} ms, plain apply "
             f"{t_apply:.1f} ms")
        if not (dh <= tol_h and dz <= tol_z):
            raise AssertionError(f"sweep kernels disagree with chase_sweep_plain on "
                                 f"[{m}, {i}]: {dh:.3e} {dz:.3e}")
        if not db <= 1e-13:
            raise AssertionError(f"B0/B disagree with apply_log_plain on [{m}, {i}]")
        if not torch.equal(Hb, Hk) or not torch.equal(Zb, Zk):
            raise AssertionError("the wrapper and the direct kernel calls differ")
        if not be_k <= 1e-13:
            raise AssertionError(f"sweep backward error {be_k:.3e} on [{m}, {i}]")
        if not (structure_ok(Hk) and structure_ok(Hp)):
            raise AssertionError(f"sweep [{m}, {i}]: structural zeros not exact")
        err_a = max(err_a, dh, dz)
        err_b = max(err_b, db)
        if (m, i) == windows[0]:
            times["plain_sweep"], times["plain_apply"] = t_plain, t_apply
        if (m, i) == windows[1]:
            # want_z=False (kernel B without Z) leaves H as with Z
            Hnz = H0.clone()
            sweep.chase_sweep(Hnz, None, m, i, v0, want_z=False)
            if not torch.equal(Hnz, Hk):
                raise AssertionError("want_z=False sweep changed H")
            _log("sweep want_z=False: H identical to want_z=True")

    # the want_t=False bound: kernel A's log on [37, 300] (rlo 37, odd and
    # off B's 32-row tiles; chi = i + 1), four random logs on [200, 400]
    for (m, i, rlo, nb) in ((37, 300, 37, 1), (200, 400, 177, 4)):
        H0 = torch.tensor(Hn, device=dev)
        H0[0, m, m - 1] = 0.0
        H0[0, i + 1, i] = 0.0
        R = (sweep.sweep_generate(H0, m, i, v0) if nb == 1 else torch.tensor(
            random_logs("real", p, n, m, i, np.random.default_rng(5), nb), device=dev))
        d, _ = apply_bound_case(dev, "real", H0, torch.tensor(Zn, device=dev), R, m, i, rlo,
                                i + 1, nb)
        err_b = max(err_b, d)

    # per-kernel times at the full window [0, n-1]
    m, i = windows[0]
    H = torch.tensor(Hn, device=dev)
    Z = torch.tensor(Zn, device=dev)
    out = {}
    ms_a = event_ms(lambda: out.update(R=sweep.sweep_generate(H, m, i, v0)), 5)
    R = out["R"]
    ms_b0 = event_ms(lambda: _cuda.check(lib.psd_sweep_left(
        H.data_ptr(), R.data_ptr(), p, N, m, i, 1, st), "sweep_left"), 5)
    ms_b = event_ms(lambda: _cuda.check(lib.psd_sweep_right(
        H.data_ptr(), Z.data_ptr(), R.data_ptr(), p, N, m, i, 1, st),
        "sweep_right"), 5)
    _log(f"sweep kernels at p={p} n={n} window [0, {n - 1}]: A {ms_a:.3f} ms "
         f"({ms_a * 1e3 / ((i - m) * p):.4f} us per (step, factor)), B0 {ms_b0:.3f} ms, "
         f"B {ms_b:.3f} ms; plain sweep {times['plain_sweep']:.1f} ms, plain apply (B0+B) "
         f"{times['plain_apply']:.1f} ms")
    apply_small_check(dev)
    headline_profile(dev)
    src = "periodicschurdecompositions_jl_torch/csrc/sweep.cu"
    # bytes and operations of the window [0, n-1] (K steps): A reads what
    # its generations depend on once, the rows m..i+1 and columns up to i+1
    # on and above the subdiagonal of H[0] and the diagonal of H[1:], and
    # writes the log; B0 and B as apply_bounds counts them; a 3x3
    # application is 15 flops per entry triple
    K = i - m
    upper = sum(i + 2 - max(r - 1, m) for r in range(m, i + 2)) + \
        (p - 1) * sum(i + 2 - max(r, m) for r in range(m, i + 2))
    bounds = {
        "sweep_generate": bound(8 * upper + 8 * 9 * p * K,
                                15 * p * sum(i + 2 - k for k in range(m, i))),
        **apply_bounds(p, n, m, i)}
    for name, ms, rep, err, pms in (
            ("sweep_generate", ms_a,
             "periodicschurdecompositions_jl_tpu/ops/pallas_sweep.py:396", err_a,
             times["plain_sweep"]),
            ("sweep_left", ms_b0,
             "periodicschurdecompositions_jl_tpu/ops/pallas_sweep.py:796", err_b,
             times["plain_apply"]),
            ("sweep_right", ms_b,
             "periodicschurdecompositions_jl_tpu/ops/pallas_sweep.py:988", err_b,
             times["plain_apply"])):
        report[name] = {"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "max_abs_err": err, "ms": ms,
                        "plain_ms": pms, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1], "library_ms": None}


def apply_bound_case(dev, kind, H0, Z0, log, m, i, rlo, chi, nb=1):
    """B0 and B of one route (``kind`` "real", "cx" or "rg") bounded to the
    want_t=False window (rows >= rlo, columns < chi) against the unbounded
    launches on the same input and log: inside the window bit for bit their
    result, outside it the input, Z bit for bit (``bounded_ok``); B bounded
    without Z leaves H as with Z; the plain version with the same bounds
    within 1e-13 (max|H| relative; Z absolute).  Returns that difference
    and the times (ms, CUDA events) of B0 and B unbounded and bounded."""
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, sweep, sweep_cx, sweep_rg
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    p, n = H0.shape[0], H0.shape[-1]
    name = {"real": "sweep", "cx": "qz_sweep", "rg": "rg_sweep"}[kind]
    nbs = (nb,) if kind == "real" else ()

    def b0(H, bounded):
        fn = getattr(lib, f"psd_{name}_left" + ("_bounded" if bounded else ""))
        _cuda.check(fn(H.data_ptr(), log.data_ptr(), p, n, m, i, *nbs,
                       *((chi,) if bounded else ()), st), f"{name}_left")

    def b(H, Z, bounded):
        fn = getattr(lib, f"psd_{name}_right" + ("_bounded" if bounded else ""))
        _cuda.check(fn(H.data_ptr(), None if Z is None else Z.data_ptr(), log.data_ptr(), p,
                       n, m, i, *nbs, *((rlo,) if bounded else ()), st), f"{name}_right")

    out = {}
    for bounded in (False, True):
        H, Z = H0.clone(), Z0.clone()
        b0(H, bounded)
        b(H, Z, bounded)
        out[bounded] = (H, Z)
    (Hu, Zu), (Hb, Zb) = out[False], out[True]
    Hz = H0.clone()
    b0(Hz, True)
    b(Hz, None, True)
    Ha, Za = H0.clone(), Z0.clone()
    if kind == "real":
        sweep.apply_log_plain(Ha, Za, log, m, i, want_z=True, nb=nb, rhi=chi, clo=rlo)
    else:
        plain = sweep_cx.qz_apply_log_plain if kind == "cx" else sweep_rg.rg_apply_log_plain
        plain(Ha, Za, log, m, i, want_z=True, rhi=chi, clo=rlo)
    d = max(float((Hb - Ha).abs().max()) / float(H0.abs().max()),
            float((Zb - Za).abs().max()))
    H, Z = H0.clone(), Z0.clone()
    ms = {"B0": event_ms(lambda: b0(H, False), 5), "B0 bounded": event_ms(lambda: b0(H, True), 5),
          "B": event_ms(lambda: b(H, Z, False), 5), "B bounded": event_ms(lambda: b(H, Z, True), 5)}
    ok = bounded_ok(H0, Hu, Hb, rlo, chi, Zu, Zb) and torch.equal(Hz, Hb)
    _log(f"{kind} B0/B want_t=False bound p={p} [{m}, {i}] NB={nb} rlo={rlo} chi={chi}: "
         f"inside the window bit for bit the unbounded launch's, outside untouched, Z bit "
         f"for bit: {ok}; B without Z: H as with Z; vs the bounded plain version {d:.3e}; "
         + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    if not ok:
        raise AssertionError(f"{kind} B0/B with the want_t=False bound on [{m}, {i}] rlo={rlo} "
                             f"chi={chi}: not the unbounded launch's inside, or touched outside")
    if not d <= 1e-13:
        raise AssertionError(f"{kind} bounded B0/B disagree with the bounded plain version")
    return d, ms


def apply_small_check(dev):
    """B0 and B at p=1 and p=3, n=101 (one tile column of B0 ragged, B's
    row tiles ragged), on windows with m = 0, a ragged span, two steps and
    one step ending at i = N-2: kernel A's log (NB = 1, exact structural
    zeros) and it followed by random orthogonal logs (NB = 2..4) against
    apply_log_plain (1e-13), and B with Z == NULL against the with-Z H, bit
    for bit.""" 
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, sweep
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    worst = 0.0
    for p, n in ((1, 101), (3, 101)):
        N = n + 1
        Hn, Zn, v0 = mk_sweep_problem(p, n, np.random.default_rng(100 + p))
        for (m, i) in ((0, n - 1), (1, 34), (50, 52), (n - 2, n - 1)):
            H0 = torch.tensor(Hn, device=dev)  # H0[0, m, m-1] != 0: B0 must keep it
            Z0 = torch.tensor(Zn, device=dev)
            q, _ = np.linalg.qr(np.random.default_rng(m).standard_normal((4, p, N, 3, 3)))
            R4 = torch.tensor(q.reshape(4, p, N, 9), device=dev)
            R4[0] = sweep.sweep_generate(H0, m, i, v0)
            for nb in (1, 2, 3, 4):
                Hb, Zb, Hz = H0.clone(), Z0.clone(), H0.clone()
                for Hx, Zx in ((Hb, Zb), (Hz, None)):
                    _cuda.check(lib.psd_sweep_left(Hx.data_ptr(), R4.data_ptr(), p, N, m, i,
                                                   nb, st), "sweep_left")
                    _cuda.check(lib.psd_sweep_right(Hx.data_ptr(), None if Zx is None
                                                    else Zx.data_ptr(), R4.data_ptr(), p, N,
                                                    m, i, nb, st), "sweep_right")
                Ha, Za = H0.clone(), Z0.clone()
                sweep.apply_log_plain(Ha, Za, R4, m, i, want_z=True, nb=nb)
                d = max(float((Hb - Ha).abs().max()) / float(H0.abs().max()),
                        float((Zb - Za).abs().max()))
                # a random log mixes row i+1 into the window (kernel A's ends
                # with a 2-reflector), so exact zeros are checked on A's only
                if not (d <= 1e-13 and torch.equal(Hz, Hb) and (nb > 1 or structure_ok(Hb))):
                    raise AssertionError(f"B0/B at p={p} n={n} [{m}, {i}] NB={nb}: {d:.3e}")
                worst = max(worst, d)
    _log(f"B0+B at p=1 and p=3, n=101, four windows, NB = 1..4: vs apply_log_plain "
         f"<= {worst:.3e}, B with Z == NULL bit for bit, exact structural zeros on A's log")


def headline_profile(dev):
    """torch.profiler over two real headline runs (p=16 n=512, seed 12345):
    the default ``pschur`` (AED and the host tail, the main path) and
    ``pschur_real_pipeline`` without them (``aed=False, host_tail=-1``).
    For each: wall, device busy time and idle share, kernel A's share of the
    device time and its time per (step, factor) on the leg's windows, B0's
    and B's device time and launches, and the reduction kernel's
    (``hess_reduce_kernel``: the cycle's reduction and, with AED, each
    window's re-reduction); with AED also its events and host seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    A = torch.tensor(np.random.default_rng(SEED_HEAD).standard_normal(
        (P_HEAD, N_HEAD, N_HEAD)), device=dev)
    legs = (("pschur (default: AED and host tail)", lambda: pt.pschur(A, "R")),
            ("pschur_real_pipeline aed=False host_tail=-1",
             lambda: pqr_real.pschur_real_pipeline(
                 A, "R", cfg=AlgoConfig(aed=False, host_tail=-1))))
    for tag, run in legs:
        torch.cuda.synchronize()
        # The trace of a whole pschur has left out the reduction's cooperative
        # launch in some runs (PERF.md section 5): the line also prints the
        # reduction's host time.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        info = pqr_real.last_info
        ev = [e for e in prof.key_averages()
              if "CUDA" in str(e.device_type) and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in ev)
        a_us = sum(dev_us(e) for e in ev if "sweep_generate_kernel" in e.key)
        b0 = [e for e in ev if "sweep_left_kernel" in e.key]
        b = [e for e in ev if "sweep_right_kernel" in e.key]
        hess = [e for e in ev if "hess_reduce_kernel" in e.key]
        steps = info["sweep_steps"]
        aed = (f"; AED {info['aed_events']} events, aed_deflated {info['aed_deflated']}, "
               f"host_tail_finished {info['host_tail_finished']}, aed_s "
               f"{info['aed_s']:.3f} s" if "aed_events" in info else "")
        _log(f"profile of one headline {tag}: niter {info['niter']}, kernel A "
             f"{a_us / 1e3:.1f} ms, {a_us / busy:.1%} of device time, "
             f"{a_us / (steps * P_HEAD):.4f} us per (step, factor) over {steps} steps; B0 "
             f"{sum(dev_us(e) for e in b0) / 1e3:.1f} ms in {sum(e.count for e in b0)}, B "
             f"{sum(dev_us(e) for e in b) / 1e3:.1f} ms in {sum(e.count for e in b)} "
             f"({sum(dev_us(e) for e in b0 + b) / busy:.1%} of device time); reduction "
             f"kernel hess_reduce_kernel {sum(dev_us(e) for e in hess) / 1e3:.1f} ms in "
             f"{sum(e.count for e in hess)} in the trace (reduction "
             f"{info['reduce_s'] * 1e3:.1f} ms on the host clock){aed}; "
             f"{profile_line(prof, wall)}")


def mb_generate(lib, st, H, m, i, v0, sig, nb, nbact, gap=MB_GAP):
    """Kernel A-mb straight through its C entry point; returns its log."""
    import ctypes
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda
    p, N, _ = H.shape
    vals = [float(x) for x in v0] + [float(x) for s3 in sig for x in s3]
    R = torch.empty((nbact, p, N, 9), dtype=torch.float64, device=H.device)
    work = torch.empty(lib.psd_sweep_generate_mb_scratch(p, N, nb, gap), dtype=torch.float64,
                       device=H.device)
    _cuda.check(lib.psd_sweep_generate_mb(H.data_ptr(), work.data_ptr(), R.data_ptr(), p, N, m,
                                          i, nb, gap, nbact,
                                          (ctypes.c_double * len(vals))(*vals), st),
                "sweep_generate_mb")
    return R


def mb_bound(p, n, m, i, nb, nbact, gap):
    """(bound_ms, bound_by) of A-mb on [m, i], and the bytes of the earlier
    reckoning.  Bytes: the entries its logs depend on, read once (per
    column c <= i+1 the rows from max(m, c - 2 - lowext), where the band
    updates reach, down to the (sub)diagonal, lowext = (nb-1) gap), and
    the nbact logs written; operations: 15 flops per entry triple of each
    bulge's left transforms on columns k..i+1 and band updates.  The
    earlier reckoning read rows m..i+1 in full."""
    lowext, K, N = (nb - 1) * gap, i - m, n + 1
    cols = range(m, i + 2)
    nz = sum(max(min(c + 1, i + 1) - max(m, c - 2 - lowext) + 1, 0) for c in cols) + \
        (p - 1) * sum(max(min(c, i + 1) - max(m, c - 2 - lowext) + 1, 0) for c in cols)
    logs = 8 * 9 * p * K * nbact
    band = sum(min(k + 3, i) - max(m, k - lowext) + 1 for k in range(m, i))
    flops = 15 * p * nbact * (sum(i + 2 - k for k in range(m, i)) + band)
    return bound(8 * nz + logs, flops), 8 * p * N * (i + 2 - m) + logs


def mb_case(dev, lib, st, Hn, Zn, v0, m, i, nbact, gap, label, nb=MB_NB):
    """A-mb -> B0 -> B on one window against the plain versions (mb_phase's
    checks 1-3); returns (the sweep's and A-mb's largest error, B0+B's,
    plain ms)."""
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, pqr_real, sweep
    p, N, _ = Hn.shape
    H0 = torch.tensor(Hn, device=dev)
    if m > 0:
        H0[0, m, m - 1] = 0.0
    H0[0, i + 1, i] = 0.0
    Z0 = torch.tensor(Zn, device=dev)
    sig = pqr_real.window_shifts(H0, i, nb)
    scale = float(H0.abs().max())
    Hk, Zk = H0.clone(), Z0.clone()
    sweep.chase_sweep_mb(Hk, Zk, m, i, v0, sig, nbact, nb=nb, gap=gap, want_z=True)
    R = mb_generate(lib, st, H0, m, i, v0, sig, nb, nbact, gap)
    Hh = torch.tensor(Hn, device=dev)
    if m > 0:
        Hh[0, m, m - 1] = 0.0
    Hh[0, i + 1, i] = 0.0
    if not torch.equal(H0, Hh):
        raise AssertionError("kernel A-mb wrote its input")
    Hp, Zp = H0.clone(), Z0.clone()
    Rp = torch.zeros((nb, p, N, 9), dtype=torch.float64, device=dev)
    tp = wall_ms(lambda: sweep.chase_sweep_mb_plain(Hp, Zp, m, i, v0, sig, nbact, nb=nb,
                                                    gap=gap, want_z=True, log=Rp))
    pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
        Hn.shape), device=dev)
    Hq, Zq = H0 * pert, Z0.clone()
    Rq = torch.zeros_like(Rp)
    sweep.chase_sweep_mb_plain(Hq, Zq, m, i, v0, sig, nbact, nb=nb, gap=gap, want_z=True,
                               log=Rq)
    sens_h = float((Hq - Hp).abs().max()) / scale
    sens_z = float((Zq - Zp).abs().max())
    sens_r = float((Rq - Rp)[:nbact, :, m:i].abs().max())
    dh = float((Hk - Hp).abs().max()) / scale
    dz = float((Zk - Zp).abs().max())
    dr = float((R - Rp[:nbact])[:, :, m:i].abs().max())
    tol_h, tol_z, tol_r = max(TOL, 10 * sens_h), max(TOL, 10 * sens_z), max(TOL, 10 * sens_r)
    Hb, Zb = H0.clone(), Z0.clone()
    _cuda.check(lib.psd_sweep_left(Hb.data_ptr(), R.data_ptr(), p, N, m, i, nbact, st),
                "sweep_left")
    _cuda.check(lib.psd_sweep_right(Hb.data_ptr(), Zb.data_ptr(), R.data_ptr(), p, N, m,
                                    i, nbact, st), "sweep_right")
    Ha, Za = H0.clone(), Z0.clone()
    sweep.apply_log_plain(Ha, Za, R, m, i, want_z=True, nb=nbact)
    db = max(float((Hb - Ha).abs().max()) / scale, float((Zb - Za).abs().max()))
    for nl in range(2, nbact):  # B0 and B with the first nl of the bulges' logs
        Hx, Zx, Hy, Zy = H0.clone(), Z0.clone(), H0.clone(), Z0.clone()
        _cuda.check(lib.psd_sweep_left(Hx.data_ptr(), R.data_ptr(), p, N, m, i, nl, st),
                    "sweep_left")
        _cuda.check(lib.psd_sweep_right(Hx.data_ptr(), Zx.data_ptr(), R.data_ptr(), p, N,
                                        m, i, nl, st), "sweep_right")
        sweep.apply_log_plain(Hy, Zy, R, m, i, want_z=True, nb=nl)
        dx = max(float((Hx - Hy).abs().max()) / scale, float((Zx - Zy).abs().max()))
        _log(f"mb B0+B with {nl} of the {nbact} bulges' logs on [{m}, {i}]: vs "
             f"apply_log_plain {dx:.3e}")
        if not (dx <= 1e-13 and structure_ok(Hx)):
            raise AssertionError(f"mb B0/B with {nl} logs disagree with apply_log_plain")
        db = max(db, dx)
    be_k = recon_err(H0, Z0, Hk, Zk)
    Hnz = H0.clone()
    sweep.chase_sweep_mb(Hnz, None, m, i, v0, sig, nbact, nb=nb, gap=gap, want_z=False)
    _log(f"mb sweep {label} p={p} [{m}, {i}], {nbact} of {nb} bulges, gap {gap}: vs "
         f"chase_sweep_mb_plain max|dH|/max|H| {dh:.3e} max|dZ| {dz:.3e}, A-mb's log "
         f"{dr:.3e} (plain's own 1e-16 sensitivity {sens_h:.3e} / {sens_z:.3e} / "
         f"{sens_r:.3e}; tolerance {tol_h:.3e} / {tol_z:.3e} / {tol_r:.3e}); B0+B vs "
         f"apply_log_plain {db:.3e}; backward error kernel {be_k:.3e}; plain sweep "
         f"{tp:.1f} ms")
    if not (dh <= tol_h and dz <= tol_z and dr <= tol_r):
        raise AssertionError(f"mb sweep kernels disagree with chase_sweep_mb_plain on "
                             f"{label} [{m}, {i}]: {dh:.3e} {dz:.3e} {dr:.3e}")
    if not db <= 1e-13:
        raise AssertionError(f"mb B0/B disagree with apply_log_plain on [{m}, {i}]")
    if not (torch.equal(Hb, Hk) and torch.equal(Zb, Zk) and torch.equal(Hnz, Hk)):
        raise AssertionError("the mb wrapper, the direct kernel calls and want_z=False "
                             "differ")
    if not be_k <= 1e-13:
        raise AssertionError(f"mb sweep backward error {be_k:.3e} on [{m}, {i}]")
    if not (structure_ok(Hk) and structure_ok(Hp)):
        raise AssertionError(f"mb sweep [{m}, {i}]: structural zeros not exact")
    return max(dh, dz, dr), db, tp


def mb_phase(dev, p, n, report):
    """Kernels A-mb -> B0 -> B (NB = 4 bulges) against the plain versions,
    on windows the plain version can afford: at gap 3 [0, 127] with four
    active bulges and [200, 263] with two; at gap 5 [300, 363] with three;
    and at p=16, n=100 with two bulges at gap 40, where even one tick's
    windows exceed a block's shared memory, so A-mb keeps them in its global
    scratch.

    1. The sweep and A-mb's log against chase_sweep_mb_plain (tick order),
       gated as in sweep_phase at max(1e-12, 10 sens), sens the plain
       version's own change under a relative 1e-16 input perturbation; A-mb
       leaves its input unchanged.
    2. B0 and B (all the bulges' logs in one pass) against apply_log_plain
       on A-mb's own log, and with its first 2 and 3 bulges' logs: 1e-13.
    3. Backward error <= 1e-13 max|H0|, exact structural zeros, want_z=False
       leaves H identical.
    4. Times at the full window [0, n-1] with four bulges: A-mb, and the
       one-bulge A on the same state; B0 and B with four bulges' logs.

    The trailing bulges' shifts are those the driver takes: the eigenvalues
    of the trailing 8 x 8 window of the cycle product (pqr_real.window_shifts).
    Shifts far from the spectrum (random ones of size 0.5 where the window's
    eigenvalues reach 1e3) make the trailing bulges' chains ill-conditioned: the plain
    version's own 1e-16 sensitivity then reaches 1e-7 on [0, 127].
    """
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, pqr_real, sweep
    rng = np.random.default_rng(2027)
    Hn, Zn, v0 = mk_sweep_problem(p, n, rng)
    N = n + 1
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    err_a = err_b = 0.0
    t_plain = None
    for (m, i, nbact, gap) in ((0, min(127, n - 1), MB_NB, MB_GAP),
                               (min(200, n - 64), min(263, n - 1), 2, MB_GAP),
                               (min(300, n - 64), min(363, n - 1), 3, 5)):
        da, db, tp = mb_case(dev, lib, st, Hn, Zn, v0, m, i, nbact, gap, "headline draw")
        t_plain = tp if t_plain is None else t_plain
        err_a, err_b = max(err_a, da), max(err_b, db)
    pg, ng, nbg, gapg = 16, 100, 2, 40
    Hg, Zg, vg = mk_sweep_problem(pg, ng, np.random.default_rng(2028))
    ring = 1 << ((nbg - 1) * gapg + 2).bit_length()  # carried rows, a power of two
    if lib.psd_sweep_generate_mb_scratch(pg, ng + 1, nbg, gapg) <= ring * pg * (ng + 1):
        raise AssertionError(f"the gap={gapg} case does not take A-mb's global windows")
    da, db, _ = mb_case(dev, lib, st, Hg, Zg, vg, 0, ng - 1, nbg, gapg, "global windows",
                        nb=nbg)
    err_a, err_b = max(err_a, da), max(err_b, db)

    # times at the full window with four bulges, and the one-bulge A there
    m, i = 0, n - 1
    H = torch.tensor(Hn, device=dev)
    Z = torch.tensor(Zn, device=dev)
    sig = pqr_real.window_shifts(H, i, MB_NB)
    out = {}
    ms_mb = event_ms(lambda: out.update(R=mb_generate(lib, st, H, m, i, v0, sig, MB_NB,
                                                      MB_NB)), 5)
    R = out["R"]
    ms_a = event_ms(lambda: sweep.sweep_generate(H, m, i, v0), 5)
    ms_b0 = event_ms(lambda: _cuda.check(lib.psd_sweep_left(
        H.data_ptr(), R.data_ptr(), p, N, m, i, MB_NB, st), "sweep_left"), 5)
    ms_b = event_ms(lambda: _cuda.check(lib.psd_sweep_right(
        H.data_ptr(), Z.data_ptr(), R.data_ptr(), p, N, m, i, MB_NB, st), "sweep_right"), 5)
    (bms, bby), old_bytes = mb_bound(p, n, m, i, MB_NB, MB_NB, MB_GAP)
    ticks = i - m + (MB_NB - 1) * MB_GAP
    _log(f"mb kernels at p={p} n={n} window [0, {n - 1}], {MB_NB} bulges: A-mb {ms_mb:.3f} ms "
         f"({ms_mb * 1e3 / (ticks * p):.4f} us per (tick, factor); one-bulge A on the same "
         f"state {ms_a:.3f} ms), B0 {ms_b0:.3f} ms, B {ms_b:.3f} ms ({MB_NB} logs each); "
         f"bound of A-mb {bms * 1e3:.3f} us ({bby}; the earlier reckoning, rows m..i+1 in "
         f"full: {old_bytes / HBM_BPS * 1e6:.3f} us of bytes); plain mb sweep "
         f"{t_plain:.1f} ms on [0, {min(127, n - 1)}]")
    report["sweep_generate_mb"] = {
        "name": "sweep_generate_mb", "route": "cuda",
        "source": "periodicschurdecompositions_jl_torch/csrc/sweep.cu",
        "replaces": "periodicschurdecompositions_jl_tpu/ops/pallas_sweep.py:548",
        "max_abs_err": max(err_a, err_b), "ms": ms_mb, "plain_ms": t_plain, "bound_ms": bms,
        "bound_by": bby, "library_ms": None}


def deflate_cases(p, n):
    """(label, H, Z, i) states that take chainA, chainB and chainB with a
    negligible trailing diagonal (the replacement loop)."""
    rng = np.random.default_rng(7)
    N = n + 1
    i = min(300, n - 2)
    cases = []
    for label in ("chainA", "chainB", "chainB-jmax"):
        H = np.zeros((p, N, N))
        H[0, :n, :n] = np.triu(rng.standard_normal((n, n)), -1)
        for f in range(1, p):
            H[f, :n, :n] = np.triu(rng.standard_normal((n, n)))
            np.fill_diagonal(H[f, :n, :n], 1.0 + rng.random(n))
        H[0, i + 1, i] = 0.0
        if label == "chainA":
            H[min(5, p - 1), i - 1, i - 1] = 1e-30
        elif label == "chainB-jmax":
            H[min(3, p - 1), i, i] = 1e-30
        Z = np.zeros((p, N, N))
        for f in range(p):
            Z[f, :n, :n] = np.linalg.qr(rng.standard_normal((n, n)))[0]
        cases.append((label, H, Z, i))
    return cases


def deflate_scalars(H, i):
    from periodicschurdecompositions_jl_torch.ops.pqr_real import defl2_scalars
    p, N, _ = H.shape
    n = N - 1
    ulp = float(np.finfo(np.float64).eps)
    smlnum = float(np.finfo(np.float64).tiny) * (n / ulp)
    hnorms = ulp * n * np.abs(H[:, :n, :n]).sum(axis=1).max(axis=1)
    D = np.stack([np.diagonal(H[f])[:n] for f in range(p)])
    U = np.stack([np.concatenate([np.diagonal(H[f], 1)[:n - 1], [0.0]])
                  for f in range(p)])
    S0 = np.concatenate([[0.0], np.diagonal(H[0], -1)[:n - 1]])
    return defl2_scalars(D, U, S0, i, p, hnorms, ulp, smlnum)


def deflate_bound(p, n):
    """Kernel D's bound on chainB with every factor in the chain (the timed
    case): of every factor, H[f]'s rows i-1, i from column i-1 (2(N-i+1)
    entries) and its columns i-1, i of rows 0..i (2(i+1)), which share the
    2x2 window, so 2N entries, and Z[f]'s columns i-1, i (2N; N = n+1), each
    read and written once; a 2x2 application is 6 flops per entry pair,
    counted once (each further round of the replacement loop applies it
    again; at the cap of 20 that stays under a fifth of the byte time)."""
    ent = p * 4 * (n + 1)
    return bound(2 * 8 * ent, 3 * ent)


def ladder_bound(p, n):
    """Kernel R's bound (open at 0): rows j..j+2 and Z's columns j..j+2 of
    every factor and H[0]'s columns j..j+2 (rows 0..ilast), read and written
    once; two rotations per entry triple are 4 flops per entry."""
    ent_r = p * (3 * n + 3 * n) + 3 * n
    return bound(2 * 8 * ent_r + 32, 4 * ent_r)


def deflate_phase(dev, p, n, report):
    import torch
    from periodicschurdecompositions_jl_torch.ops import deflate
    worst = 0.0
    times = {}
    for (label, Hn, Zn, i) in deflate_cases(p, n):
        sc = deflate_scalars(Hn, i)
        args = (i, sc["jmin"], sc["jmax"], sc["cs0"], sc["sn0"], sc["replace0"],
                sc["finzero"], sc["thr"])
        if label == "chainA" and sc["jmin"] < 1:
            raise AssertionError("chainA case did not select chainA")
        if label != "chainA" and sc["jmin"] >= 1:
            raise AssertionError(f"{label} case selected chainA")
        H0 = torch.tensor(Hn, device=dev)
        Z0 = torch.tensor(Zn, device=dev)
        Hk, Zk = H0.clone(), Z0.clone()
        deflate.deflate2x2(Hk, Zk, *args, want_z=True)
        Hp, Zp = H0.clone(), Z0.clone()
        t_plain = wall_ms(lambda: deflate.deflate2x2_plain(Hp, Zp, *args, want_z=True))
        scale = float(H0.abs().max())
        dH = float((Hk - Hp).abs().max())
        dZ = float((Zk - Zp).abs().max())
        Ht, Zt = H0.clone(), Z0.clone()
        t_k = event_ms(lambda: deflate.deflate2x2(Ht, Zt, *args, want_z=True), 5)
        _log(f"deflate {label} (jmin {sc['jmin']}, jmax {sc['jmax']}, replace0 "
             f"{sc['replace0']}): max|dH| {dH:.3e} (scale {scale:.3e}), max|dZ| "
             f"{dZ:.3e}; kernel {t_k:.4f} ms, plain {t_plain:.2f} ms; H, Z sha256 "
             f"{sha(Hk)} {sha(Zk)}")
        if not (dH <= TOL * scale and dZ <= TOL):
            raise AssertionError(f"deflate kernel disagrees on {label}")
        if not torch.equal(Hk == 0, Hp == 0):
            raise AssertionError(f"deflate kernel on {label}: exact zeros not the plain's")
        worst = max(worst, dH / scale, dZ)
        times[label] = (t_k, t_plain)
        # the want_t=False bound (rlo = i - 1, chi = i + 1: the 2x2 window
        # alone) and a wider one (rlo 37, odd; chi = i + 9): against the
        # unbounded launch (bit for bit inside, untouched outside, Z bit for
        # bit), without Z, and against the bounded plain version
        for rlo, chi in ((i - 1, i + 1), (37, i + 9)):
            Hb, Zb, Hz = H0.clone(), Z0.clone(), H0.clone()
            deflate.deflate2x2(Hb, Zb, *args, want_z=True, rhi=chi, clo=rlo)
            deflate.deflate2x2(Hz, None, *args, want_z=False, rhi=chi, clo=rlo)
            Hp, Zp = H0.clone(), Z0.clone()
            deflate.deflate2x2_plain(Hp, Zp, *args, want_z=True, rhi=chi, clo=rlo)
            dB = max(float((Hb - Hp).abs().max()) / scale, float((Zb - Zp).abs().max()))
            ok = bounded_ok(H0, Hk, Hb, rlo, chi, Zk, Zb) and torch.equal(Hz, Hb)
            Ht, Zt = H0.clone(), Z0.clone()
            t_b = event_ms(lambda: deflate.deflate2x2(Ht, Zt, *args, want_z=True, rhi=chi,
                                                      clo=rlo), 5)
            _log(f"deflate {label} want_t=False bound rlo={rlo} chi={chi}: inside bit for bit "
                 f"the unbounded launch's, outside untouched, Z bit for bit, without Z H as "
                 f"with Z: {ok}; vs the bounded plain version {dB:.3e}; kernel {t_b:.4f} ms")
            if not (ok and dB <= TOL):
                raise AssertionError(f"deflate {label}: the want_t=False bound rlo={rlo} "
                                     f"chi={chi} fails")
            worst = max(worst, dB)
    t_k, t_plain = times["chainB"]
    bms, bby = deflate_bound(p, n)
    report["deflate2x2"] = {
        "name": "deflate2x2", "route": "cuda",
        "source": "periodicschurdecompositions_jl_torch/csrc/deflate.cu",
        "replaces": "periodicschurdecompositions_jl_tpu/ops/pallas_deflate.py:71",
        "max_abs_err": worst, "ms": t_k, "plain_ms": t_plain, "bound_ms": bms,
        "bound_by": bby, "library_ms": None}


def hess_work(p, n, cplx=False):
    """(bytes, flops) of one reduction with Q: A read once, H and Q written
    once (8 bytes an entry, 16 in complex128); per stage (i, j) whose
    reflector is not trivial, with window length k = n - lo, the xLARFG (3k),
    the left update of A[j] (4 k (n-i-1)) and the right updates of A[j-1]
    and Q[j] (4 n k each), a complex multiply-add counted as 8 real
    operations (so 4x those counts in complex128).  Real: a window with an
    empty tail (k = 1) gives tau = 0 and no update.  Complex: such a window
    still has tau != 0 unless alpha is real, which a random complex draw's
    never is, so every stage counts."""
    flops = 0
    for i in range(n - 1):
        for j in range(p):
            k = n - (i + 1 if j == 0 else i)
            if k >= (1 if cplx else 2):
                flops += 3 * k + 4 * k * (n - i - 1) + 8 * n * k
    return (16 if cplx else 8) * 3 * p * n * n, flops * (4 if cplx else 1)


def hess_cases():
    """(name, p, n, A) of hess_phase: the real headline draw, p=1 n=64 and
    p=3 n=101; in complex128 the complex leg's draw (p=8 n=256 seed 777), the
    same two small shapes, and a cycle whose columns already have zero tails
    but complex diagonals (every tau != 0: the updates must run)."""
    def cplx(rng, shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    out = []
    for (p, n, seed) in ((P_HEAD, N_HEAD, SEED_HEAD), (1, 64, 64), (3, 101, 101)):
        out.append((f"real p={p} n={n} seed={seed}", p, n,
                    np.random.default_rng(seed).standard_normal((p, n, n))))
    for (p, n, seed) in ((P_CX, N_CX, SEED_CX), (1, 64, 64), (3, 101, 101)):
        out.append((f"complex p={p} n={n} seed={seed}", p, n,
                    cplx(np.random.default_rng(seed), (p, n, n))))
    Z = np.triu(cplx(np.random.default_rng(5), (3, 48, 48)))
    Z[0] += np.diag(cplx(np.random.default_rng(6), (47,)), -1)
    out.append(("complex zero tails p=3 n=48", 3, 48, Z))
    return out


def hess_phase(dev, report):
    """The reduction kernel (csrc/hess.cu), float64 and complex128, against
    phessenberg_core_plain on the card, on the cases of hess_cases.

    1. max|dH|/max|A| and max|dQ| within max(1e-11, 10 sens), sens being the
       plain version's own change when A is perturbed by a relative 1e-16.
    2. The kernel's similarity residual max_l |Q_l^H A_l Q_{l+1} - H_l| /
       max|A| <= 2e-13, orthonormality max_l ||Q_l Q_l^H - I||_1 <= 10 eps n,
       exact structural zeros, and want_q=False leaves H identical.
    3. One reduction adds one launch (the cooperative kernel) to the counter.
    """
    import torch
    from periodicschurdecompositions_jl_torch.ops import hessenberg
    worst = {"hess_reduce": 0.0, "hess_reduce_c128": 0.0}
    for (name, p, n, An) in hess_cases():
        A = torch.tensor(An, device=dev)
        cx = A.is_complex()
        key = "hess_reduce_c128" if cx else "hess_reduce"
        scale = float(A.abs().max())
        hessenberg.launches["hess_reduce"] = 0
        H, Q = hessenberg.phessenberg_core(A)
        if hessenberg.launches["hess_reduce"] != 1:
            raise AssertionError(f"hess {name}: {hessenberg.launches['hess_reduce']} "
                                 f"launches counted, 1 expected")
        out = {}
        t_plain = wall_ms(lambda: out.update(hq=hessenberg.phessenberg_core_plain(A)))
        Hp, Qp = out.pop("hq")
        pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
            (p, n, n)), device=dev)
        Hq, Qq = hessenberg.phessenberg_core_plain(A * pert)
        sens_h = float((Hq - Hp).abs().max()) / scale
        sens_q = float((Qq - Qp).abs().max())
        del Hq, Qq, pert
        dh = float((H - Hp).abs().max()) / scale
        dq = float((Q - Qp).abs().max())
        tol_h, tol_q = max(1e-11, 10 * sens_h), max(1e-11, 10 * sens_q)
        eye = torch.eye(n, dtype=A.dtype, device=dev)
        res = max(float((Q[l].mH @ A[l] @ Q[(l + 1) % p] - H[l]).abs().max())
                  for l in range(p)) / scale
        orth = max(float(torch.linalg.matrix_norm(Q[l] @ Q[l].mH - eye, ord=1))
                   for l in range(p))
        orth_bound = 10 * np.finfo(np.float64).eps * n
        Hn, Qn = hessenberg.phessenberg_core(A, want_q=False)
        ms = event_ms(lambda: hessenberg.phessenberg_core(A), 3)
        nb, fl = hess_work(p, n, cx)
        bms, bby = bound(nb, fl)
        _log(f"hess reduction {name}: vs phessenberg_core_plain max|dH|/max|A| {dh:.3e} "
             f"max|dQ| {dq:.3e} (plain's own 1e-16 sensitivity {sens_h:.3e} / "
             f"{sens_q:.3e}; tolerance {tol_h:.3e} / {tol_q:.3e}); kernel residual "
             f"{res:.3e}, orthonormality {orth:.3e} (bound {orth_bound:.3e}); kernel "
             f"{ms:.3f} ms (1 launch, {p * (n - 1)} stages), plain {t_plain:.1f} ms, "
             f"bound {bms * 1e3:.3f} us ({bby})")
        if not (dh <= tol_h and dq <= tol_q):
            raise AssertionError(f"hess kernel disagrees with the plain version, {name}: "
                                 f"{dh:.3e} {dq:.3e}")
        if not (res <= 2e-13 and orth <= orth_bound):
            raise AssertionError(f"hess kernel residual {res:.3e} / orthonormality "
                                 f"{orth:.3e}, {name}")
        if not (structure_ok(H) and structure_ok(Hp)):
            raise AssertionError(f"hess {name}: structural zeros not exact")
        if not (Qn is None and torch.equal(Hn, H)):
            raise AssertionError(f"hess {name}: want_q=False changed H")
        worst[key] = max(worst[key], dh, dq)
        if (p, n) in ((P_HEAD, N_HEAD), (P_CX, N_CX)):
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                hessenberg.phessenberg_core(A)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            _log(f"profile of one kernel reduction {name}: {profile_line(prof, wall)}")
            report[key] = {
                "name": key, "route": "cuda",
                "source": "periodicschurdecompositions_jl_torch/csrc/hess.cu",
                # the complex instance stands for the JAX package's jnp reduction
                "replaces": "periodicschurdecompositions_jl_tpu/ops/"
                + ("hessenberg.py:45" if cx else "pallas_hess.py:127"),
                "ms": ms, "plain_ms": t_plain, "bound_ms": bms, "bound_by": bby,
                "library_ms": None}
    for key, err in worst.items():
        report[key]["max_abs_err"] = err


def hess_signed_work(p, n, cplx=False, want_q=True):
    """(bytes, flops) of stage 2 of one signed reduction: H and Q read once
    and written once (8 bytes an entry, 16 in complex128); per chain j (m =
    n-j-2 rotations) the updated entries: factor 0's rows (2 (n-j-1) a
    rotation) and final columns (2 n), each factor l >= 1's columns and rows
    (2 n + 2 a rotation, direct or inverted), and 2 n of each Q; 3 real
    operations an entry (a complex one counted as 4x a real one, as
    hess_work does) and 10 a generation."""
    ent = 0
    for j in range(n - 2):
        m = n - j - 2
        ent += m * (2 * (n - j - 1) + 2 * n) + (p - 1) * m * (2 * n + 2)
        if want_q:
            ent += p * m * 2 * n
    gens = p * (n - 2) * (n - 1) // 2
    return ((16 if cplx else 8) * (4 if want_q else 2) * p * n * n,
            (3 * ent + 10 * gens) * (4 if cplx else 1))


def hess_signed_cases():
    """(name, S, A) of hess_signed_phase: the rg leg's draw and the signed
    complex leg's (both alternating S), then small edge shapes in float64
    and complex128."""
    def cplx(rng, shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    alt4 = alternating(4)
    out = [(f"real p={P_RG} n={N_RG} seed={SEED_RG}", alternating(P_RG),
            np.random.default_rng(SEED_RG).standard_normal((P_RG, N_RG, N_RG))),
           (f"complex p={P_CX} n={N_CX_SIGNED} seed={SEED_CX}", alternating(P_CX),
            cplx(np.random.default_rng(SEED_CX), (P_CX, N_CX_SIGNED, N_CX_SIGNED)))]
    for (S, n) in (((True, False), 3), ((True, False, False), 37), (alt4, 64),
                   ((True, True, True), 40), ((True,), 20)):
        for kind in ("real", "complex"):
            rng = np.random.default_rng(100 * len(S) + n)
            A = cplx(rng, (len(S), n, n)) if kind == "complex" else \
                rng.standard_normal((len(S), n, n))
            out.append((f"{kind} p={len(S)} n={n}", S, A))
    Z = np.random.default_rng(9).standard_normal((4, 9, 9))
    Z[3] = np.triu(Z[3])
    Z[3, 2, 2] = 0.0    # stage 1 keeps it: an exact zero on an inverted diagonal
    out.append(("real p=4 n=9 planted zero", alt4, Z))
    return out


def hess_signed_phase(dev, report):
    """Stage 2 of the signed reduction (csrc/hess_signed.cu), float64 and
    complex128, against phessenberg_signed_core_plain on the card, on the
    cases of hess_signed_cases.

    1. max|dH|/max|A| and max|dQ| within max(1e-12, 10 sens), sens being the
       change of the plain version when A is perturbed by a relative 1e-16.
       At the rg leg's draw the plain version takes ~40-60 s a call, so it
       runs once there and sens is the kernel's own change under the same
       perturbation (printed beside the plain version's at every other
       case, the signed complex leg's draw included).  On the planted zero
       the chains turn the exact zero into rounding noise that later
       generations read, so there sens is O(1) and check 2 decides.
    2. The kernel's similarity residual <= 1e-12 max|A|, orthonormality <=
       10 eps n, exact structural zeros, the input unchanged, and
       want_q=False leaves H identical.
    3. One reduction adds one launch to the counter.
    Prints the kernel's time (CUDA events over stage 2 alone, on copies of
    stage 1's output), the plain version's wall and the bound.
    """
    import torch
    from periodicschurdecompositions_jl_torch.ops import hessenberg, sweep_cx
    worst = {"hess_signed": 0.0, "hess_signed_c128": 0.0}
    for idx, (name, S, An) in enumerate(hess_signed_cases()):
        A = torch.tensor(An, device=dev)
        A0 = A.clone()
        p, n, _ = A.shape
        cx = A.is_complex()
        key = "hess_signed_c128" if cx else "hess_signed"
        scale = float(A.abs().max())
        hessenberg.launches["hess_signed"] = 0
        H, Q = hessenberg.phessenberg_signed_core(A, S)
        if hessenberg.launches["hess_signed"] != 1:
            raise AssertionError(f"hess_signed {name}: {hessenberg.launches['hess_signed']} "
                                 f"launches counted, 1 expected")
        out = {}
        t_plain = wall_ms(lambda: out.update(hq=hessenberg.phessenberg_signed_core_plain(A, S)))
        Hp, Qp = out.pop("hq")
        pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
            (p, n, n)), device=dev)
        Hk, Qk = hessenberg.phessenberg_signed_core(A * pert, S)
        ksens = max(float((Hk - H).abs().max()) / scale, float((Qk - Q).abs().max()))
        if idx == 0:
            psens = None
            sens = ksens
        else:
            Hs, Qs = hessenberg.phessenberg_signed_core_plain(A * pert, S)
            psens = max(float((Hs - Hp).abs().max()) / scale, float((Qs - Qp).abs().max()))
            sens = psens
            del Hs, Qs
        del Hk, Qk, pert
        dh = float((H - Hp).abs().max()) / scale
        dq = float((Q - Qp).abs().max())
        tol = max(1e-12, 10 * sens)
        eye = torch.eye(n, dtype=A.dtype, device=dev)
        res = 0.0
        for l in range(p):
            a, b = (l, (l + 1) % p) if S[l] else ((l + 1) % p, l)
            res = max(res, float((Q[a].mH @ A[l] @ Q[b] - H[l]).abs().max()) / scale)
        orth = max(float(torch.linalg.matrix_norm(Q[l] @ Q[l].mH - eye, ord=1))
                   for l in range(p))
        orth_bound = 10 * np.finfo(np.float64).eps * n
        Hn, Qn = hessenberg.phessenberg_signed_core(A, S, want_q=False)
        H1, Q1 = hessenberg._signed_stage1(A, S, True)
        sig = sweep_cx._signature(S, dev)
        ts = []
        for _ in range(4):
            Hc, Qc = H1.clone(), Q1.clone()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            hessenberg.signed_stage2_cuda(Hc, Qc, sig)
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        ms = float(np.median(ts[1:]))
        t_whole = wall_ms(lambda: hessenberg.phessenberg_signed_core(A, S))
        nb, fl = hess_signed_work(p, n, cx)
        bms, bby = bound(nb, fl)
        _log(f"hess_signed {name} S={''.join('TF'[not x] for x in S)}: vs "
             f"phessenberg_signed_core_plain max|dH|/max|A| {dh:.3e} max|dQ| {dq:.3e} "
             f"(1e-16 sensitivity: plain's "
             f"{'not run' if psens is None else f'{psens:.3e}'}, kernel's {ksens:.3e}; "
             f"tolerance {tol:.3e}); residual {res:.3e}, orthonormality {orth:.3e} (bound "
             f"{orth_bound:.3e}); stage 2 kernel {ms:.3f} ms (1 launch, "
             f"{p * (n - 2) * (n - 1) // 2} generations), whole kernel reduction "
             f"{t_whole:.1f} ms, plain {t_plain:.1f} ms, bound {bms * 1e3:.3f} us ({bby})")
        if not (dh <= tol and dq <= tol):
            raise AssertionError(f"hess_signed kernel disagrees with the plain version, "
                                 f"{name}: {dh:.3e} {dq:.3e}")
        if not (res <= 1e-12 and orth <= orth_bound):
            raise AssertionError(f"hess_signed residual {res:.3e} / orthonormality "
                                 f"{orth:.3e}, {name}")
        if not (structure_ok(H) and structure_ok(Hp)):
            raise AssertionError(f"hess_signed {name}: structural zeros not exact")
        if not torch.equal(A, A0):
            raise AssertionError(f"hess_signed {name}: the input changed")
        if not (Qn is None and torch.equal(Hn, H)):
            raise AssertionError(f"hess_signed {name}: want_q=False changed H")
        worst[key] = max(worst[key], dh, dq)
        if idx < 2:
            report[key] = {
                "name": key, "route": "cuda",
                "source": "periodicschurdecompositions_jl_torch/csrc/hess_signed.cu",
                # stage 2 of the JAX package's jnp phessenberg_signed_core (no Pallas kernel)
                "replaces": "periodicschurdecompositions_jl_tpu/ops/hessenberg.py:167",
                "ms": ms, "plain_ms": t_plain, "bound_ms": bms, "bound_by": bby,
                "library_ms": None}
    for (p, n, kind) in ((3, 1, "complex"), (4, 2, "real")):
        A = torch.tensor(np.random.default_rng(n).standard_normal((p, n, n)), device=dev)
        A = A.to(torch.complex128) if kind == "complex" else A
        hessenberg.launches["hess_signed"] = 0
        H, Q = hessenberg.phessenberg_signed_core(A, alternating(p))
        Hp, Qp = hessenberg.phessenberg_signed_core_plain(A, alternating(p))
        if hessenberg.launches["hess_signed"] != 0 or not (torch.equal(H, Hp)
                                                           and torch.equal(Q, Qp)):
            raise AssertionError(f"hess_signed n={n}: launched, or differs from the plain "
                                 f"version without chains")
    _log("hess_signed n=1 (complex) and n=2 (real): no launch, equal to the plain version")
    for key, err in worst.items():
        report[key]["max_abs_err"] = err


def glue_phase(dev, states, report):
    """Kernel G (csrc/glue.cu) against glue_plain, on the card and on a CPU
    copy, bit for bit (the whole packed buffer: band, lnew, v0 and the
    factor entries; the CPU tests hold glue_plain to the numpy host glue bit
    for bit), on states of the headline iteration captured by
    capture_glue_states, under the default configuration and, on the first
    state, slicot_convg and slicot_shifts."""
    import torch
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import _cuda, glue
    err = 0.0
    t_plain = None
    _, Hp, l, i, its = states[0]
    glue.glue_plain(Hp, Hp.shape[1] - 1, l, i, its, AlgoConfig())  # warm-up
    for (label, Hp, l, i, its) in states:
        p, N, _ = Hp.shape
        n = N - 1
        cfgs = [AlgoConfig()]
        if label == states[0][0]:
            cfgs += [AlgoConfig(slicot_convg=True), AlgoConfig(slicot_shifts=True)]
        for cfg in cfgs:
            k = glue.glue_cuda(Hp, n, l, i, its, cfg).cpu()
            out = {}
            tp = wall_ms(lambda: out.update(b=glue.glue_plain(Hp, n, l, i, its, cfg)))
            t_plain = tp if t_plain is None else t_plain
            ref = out["b"].cpu()
            ref_cpu = glue.glue_plain(Hp.cpu(), n, l, i, its, cfg)
            e = max(float((k - ref).abs().max()), float((k - ref_cpu).abs().max()))
            same = torch.equal(k, ref) and torch.equal(k, ref_cpu)
            _log(f"glue state {label} (l={l}, i={i}, its={its}, slicot_convg="
                 f"{cfg.slicot_convg}, slicot_shifts={cfg.slicot_shifts}): lnew {int(k[0])}, "
                 f"bitwise equal to glue_plain on the card and on the CPU: {same} (max "
                 f"diff {e:.3e}); glue_plain {tp:.2f} ms")
            if not same:
                raise AssertionError(f"kernel G differs from glue_plain on {label}")
            err = max(err, e)
    label, Hp, l, i, its = states[0]
    p, N, _ = Hp.shape
    n = N - 1
    # the kernel alone (preallocated buffers, straight through the C entry
    # point), glue_cuda (buffer allocation, launch; no copy back) and a whole
    # call of glue_products_scan_shift
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    k = glue.out_len(p, n)
    buf = torch.empty(k + 3 * n, dtype=torch.float64, device=dev)
    ulp, ulpx, smlnum = glue.scan_constants(n, AlgoConfig())
    ms = event_ms(lambda: _cuda.check(lib.psd_glue(
        Hp.data_ptr(), buf.data_ptr(), buf.data_ptr() + 8 * k, p, n, l, i, its, 0, 0, ulp,
        ulpx, smlnum, st), "glue"), 200)
    ms_wrap = event_ms(lambda: glue.glue_cuda(Hp, n, l, i, its, AlgoConfig()), 200)
    # one iteration's call, the read-back and the unpacking included (it
    # waits for its copy: the host clock, median of 200 calls)
    calls = []
    bufs = glue.glue_buffers(Hp, n)
    for _ in range(201):
        t0 = time.perf_counter()
        glue.glue_products_scan_shift(Hp, n, l, i, its, AlgoConfig(), bufs)
        calls.append(time.perf_counter() - t0)
    us_call = float(np.median(calls[1:])) * 1e6
    # reads the diagonals 0 and 1 of every factor, diagonal 2 of H[1..p-1]
    # and H[0]'s subdiagonal (3 p n doubles), writes the buffer; the band
    # recurrence is 8 flops per (factor, row), the product with H[0] 8 per
    # row, the scan about 25 per row of the window
    bms, bby = bound(8 * (3 * p * n + glue.out_len(p, n)),
                     8 * p * n + 25 * (i - l) + 80)
    _log(f"kernel G at p={p} n={n} (state {label}): {ms * 1e3:.2f} us per launch "
         f"({ms_wrap * 1e3:.2f} us through glue_cuda, {us_call:.2f} us a call of "
         f"glue_products_scan_shift with its read-back and unpacking), glue_plain "
         f"{t_plain:.2f} ms, bound {bms * 1e3:.4f} us ({bby})")
    report["glue"] = {
        "name": "glue", "route": "cuda",
        "source": "periodicschurdecompositions_jl_torch/csrc/glue.cu",
        "replaces": "periodicschurdecompositions_jl_tpu/ops/pallas_glue.py:98",
        "max_abs_err": err, "ms": ms, "plain_ms": t_plain, "bound_ms": bms,
        "bound_by": bby, "library_ms": None}


def backerr(A, T, Z, left=False):
    """max_l max|Z T Z' - A| / max|A| per factor (bench.py's definition)."""
    p = T.shape[0]
    worst = 0.0
    scale = np.abs(A).max()
    for l in range(p):
        ln = (l + 1) % p
        Ax = Z[ln] @ T[l] @ Z[l].T if left else Z[l] @ T[l] @ Z[ln].T
        worst = max(worst, np.abs(Ax - A[l]).max() / scale)
    return worst


def eig_dist(w, ref):
    """Largest distance from an eigenvalue of either set to the nearest of
    the other (a matching that needs no sort order)."""
    d = np.abs(w[:, None] - ref[None, :])
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def e2e_case(dev, p, n, seed, lr, nbulges=1, ref_values=None, aed=False):
    """The real path on a real cycle.  ``aed``: ``pschur`` with its default
    configuration (aggressive early deflation and the host tail, which must
    both have deflated); else ``pschur_real_pipeline(A, lr,
    cfg=AlgoConfig(nbulges=..., aed=False, host_tail=-1))``, the iteration
    without them.  Returns the launch counts and the iteration info with
    the wall clock, the backward error and the eigenvalues; kernel G must
    have launched once per iteration, and every sweep went through the
    one-bulge kernel A or, with nbulges > 1, through A-mb.  ``ref_values``:
    eigenvalues of the same product from another leg, to agree within 1000
    eps max|lambda|."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import (deflate, glue, hessenberg, pqr_real,
                                                         sweep)
    A = np.random.default_rng(seed).standard_normal((p, n, n))
    At = torch.tensor(A, device=dev)
    counters = [sweep.launches, deflate.launches, hessenberg.launches, glue.launches]
    for d in counters:
        for k in d:
            d[k] = 0
    t0 = time.perf_counter()
    if aed:
        P = pt.pschur(At, lr)
    else:
        P = pqr_real.pschur_real_pipeline(At, lr, cfg=AlgoConfig(
            nbulges=nbulges, bulge_gap=MB_GAP, aed=False, host_tail=-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for d in counters for k, v in d.items()}
    info = dict(pqr_real.last_info)
    T = P.Ts.cpu().numpy()
    Z = P.Zs.cpu().numpy()
    # residual multiplier 200 as tests/test_pqr_real.py uses for this core;
    # check_psd's default 100 is the reference's small-n CI bound
    ok, rep = pt.check_psd(P, A, tol=200.0)
    be = backerr(A, T, Z, left=(lr == "L"))
    orth_bound = 10 * np.finfo(np.float64).eps * n
    vals = P.values.cpu().numpy()
    tag = ("pschur (default: AED and host tail)" if aed else "pschur_real_pipeline "
           f"aed=False host_tail=-1{'' if nbulges == 1 else f' nbulges={nbulges}'}")
    msg = ""
    if ref_values is not None:
        ev = eig_dist(vals, ref_values) / np.abs(ref_values).max()
        msg = f", eigenvalues vs the nbulges=1 AED-off leg {ev:.3e} max|lambda|"
    if aed:
        msg += (f"; AED: {info['aed_events']} events, {info['aed_hits']} deflating, "
                f"aed_deflated {info['aed_deflated']}, host_tail_finished "
                f"{info['host_tail_finished']}, aed_s {info['aed_s']:.3f} s of host analysis")
    _log(f"{tag} p={p} n={n} seed={seed} lr={lr}: wall {wall:.3f} s (reduction "
         f"{info['reduce_s']:.3f} s, iteration {info['iterate_s']:.3f} s), niter "
         f"{info['niter']}, sweeps {info['sweeps']}, bulges {info['bulges']}, chase steps "
         f"{info['sweep_steps']}, backerr {be:.3e}, check_psd ok={ok} orth "
         f"{rep['orthonormality']:.3e} (bound {orth_bound:.3e}) residual "
         f"{rep['residual_rel']:.3e}{msg}; launches {launches}")
    if not ok:
        raise AssertionError(f"check_psd failed: {rep}")
    if not (be <= 1e-12):
        raise AssertionError(f"backward error {be:.3e} > 1e-12")
    if not (rep["orthonormality"] <= orth_bound):
        raise AssertionError("orthonormality above 10 eps n")
    if not (np.all(np.isfinite(vals)) and vals.shape == (n,)):
        raise AssertionError("eigenvalues not finite or of the wrong shape")
    if ref_values is not None and not ev <= 1000 * np.finfo(np.float64).eps:
        raise AssertionError(f"eigenvalues differ from the nbulges=1 AED-off leg's by {ev:.3e}")
    if aed and not (info["aed_deflated"] > 0 and info["host_tail_finished"] > 0):
        raise AssertionError(f"AED deflated {info['aed_deflated']}, the host tail finished "
                             f"{info['host_tail_finished']}: both must be > 0")
    # the signed reduction and the shard entries are not on the real direct path
    unused = ("sweep_generate_mb" if nbulges == 1 else "sweep_generate", "hess_signed",
              "sweep_left_shard", "sweep_right_shard")
    for k, v in launches.items():
        if (v <= 0) != (k in unused):
            raise AssertionError(f"kernel {k} launched {v} times on the {tag} path")
    if launches["glue"] != info["niter"]:
        raise AssertionError(f"kernel G launched {launches['glue']} times in "
                             f"{info['niter']} iterations")
    if launches["sweep_left"] != info["sweeps"]:
        raise AssertionError(f"{launches['sweep_left']} sweeps launched, {info['sweeps']} "
                             f"counted")
    return launches, {**info, "wall_s": wall, "backerr": be, "values": vals}


def reorder_phase(dev):
    """``ordschur`` and ``eigvecs`` on a decomposition on the card:
    ``pschur`` of a real p=4 n=64 cycle (seed 64), ``ordschur`` of three
    values (widened over conjugate pairs) with ``check_psd`` of the result
    against the cycle, its tensors on the card and bit for bit the same
    reordering of a CPU copy; ``eigvecs`` of the two values of largest
    modulus, on the card, with the residual of ``A[0] ... A[3] v = lambda v``
    relative to |lambda| |v|."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    p, n = 4, 64
    A = np.random.default_rng(64).standard_normal((p, n, n))
    P = pt.pschur(torch.tensor(A, device=dev), "R")
    vals = P.values.cpu().numpy()
    select = [j in (5, n // 2, n - 1) for j in range(n)]
    t0 = time.perf_counter()
    P2 = pt.ordschur(P, select)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    Pc = pt.PeriodicSchur(Ts=P.Ts.cpu(), Zs=P.Zs.cpu(), values=P.values.cpu(),
                          orientation=P.orientation, schurindex=P.schurindex)
    P2c = pt.ordschur(Pc, select)
    ok, rep = pt.check_psd(P2, A, tol=2000.0)
    on_card = all(t.device.type == "cuda" for t in (P2.Ts, P2.Zs, P2.values))
    same = all(torch.equal(a.cpu(), b) for a, b in ((P2.Ts, P2c.Ts), (P2.Zs, P2c.Zs),
                                                    (P2.values, P2c.values)))
    k = int(np.sum(select))  # before widening over pairs: at most 2k lead
    top = P2.values.cpu().numpy()[:2 * k]
    led = max(min(abs(top - v)) / abs(v) for v in vals[np.asarray(select)])
    big = [int(j) for j in np.argsort(-np.abs(vals))[:2]]
    Vs = pt.eigvecs(P, [j in big for j in range(n)])
    M = A[0] @ A[1] @ A[2] @ A[3]
    lam = vals[np.asarray([j in big for j in range(n)])]
    V0 = Vs[0].cpu().numpy()
    res = max(np.linalg.norm(M @ V0[:, c] - lam[c] * V0[:, c])
              / (abs(lam[c]) * np.linalg.norm(V0[:, c])) for c in range(len(lam)))
    _log(f"ordschur on the card p={p} n={n}: {secs:.3f} s, check_psd ok={ok} residual "
         f"{rep['residual_rel']:.3e} orth {rep['orthonormality']:.3e}, selected values "
         f"lead within {led:.3e} relative, on the card {on_card}, equal to the CPU "
         f"reordering {same}; eigvecs of the two largest: {len(Vs)} matrices on "
         f"{Vs[0].device}, residual {res:.3e}")
    if not (ok and on_card and same and led <= 1e-10):
        raise AssertionError("ordschur on the card failed its checks")
    if not (len(Vs) == p and all(v.device.type == "cuda" for v in Vs) and res <= 1e-10):
        raise AssertionError("eigvecs on the card failed its checks")


class capture_glue_states:
    """Within the block, keeps a few states of the real iteration for
    glue_phase: the padded stack and l, i, its at kernel G's first call,
    calls 333 and 666, the first call with its == 10, the first with its >=
    16 and the first whose lnew > 0 (a clone of the stack at each, six in
    all)."""

    def __enter__(self):
        from periodicschurdecompositions_jl_torch.ops import pqr_real
        self.run = run = pqr_real.glue_products_scan_shift
        self.states = states = {}
        calls = [0]

        def capture(Hp, n, l, i, its, cfg, bufs=None):
            c = calls[0]
            calls[0] += 1
            for label, want in ((f"call {c}", c in (0, 333, 666)), ("its==10", its == 10),
                                ("its>=16", its >= 16)):
                if want and label not in states:
                    states[label] = (label, Hp.clone(), l, i, its)
            g = run(Hp, n, l, i, its, cfg, bufs)
            if g.lnew > 0 and "lnew>0" not in states:  # G reads Hp only
                states["lnew>0"] = ("lnew>0", Hp.clone(), l, i, its)
            return g
        pqr_real.glue_products_scan_shift = capture
        return self

    def __exit__(self, *exc):
        from periodicschurdecompositions_jl_torch.ops import pqr_real
        pqr_real.glue_products_scan_shift = self.run
        _, H0, l0, i0, _ = self.states["call 0"]
        for label, its in (("its==10", 10), ("its>=16", 16)):
            if label not in self.states:  # the run had none: the first state at that its
                self.states[label] = (f"call 0 at its={its}", H0, l0, i0, its)
        return False


def small_reference_check(dev):
    """A small cycle on the card: eigenvalues against numpy's eigvals of
    the explicit product."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    A = np.random.default_rng(3).standard_normal((3, 10, 10))
    P = pt.pschur(torch.tensor(A, device=dev), "R")
    ok, _ = pt.check_psd(P, A)
    w = np.sort_complex(P.values.cpu().numpy())
    ref = np.sort_complex(np.linalg.eigvals(A[0] @ A[1] @ A[2]))
    err = np.abs(w - ref).max() / np.abs(ref).max()
    _log(f"small reference check p=3 n=10: eigenvalue error {err:.3e}, ok={ok}")
    if not (ok and err < 1e-10):
        raise AssertionError("small reference check failed")


# ---------------------------------------------------------------------------
# complex periodic QZ


def alternating(p):
    return tuple(l % 2 == 0 for l in range(p))


def mk_cx_problem(p, n, rng):
    """Complex Hessenberg-triangular cycle, unitary Z and a shift rotation.

    As tests/test_pallas_cx.py::_mk_problem, except that the triangular
    factors' diagonals have modulus in [1, 2) (the same reason as
    mk_sweep_problem's)."""
    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    H = np.zeros((p, n, n), complex)
    H[0] = np.triu(cplx(n, n), -1)
    for f in range(1, p):
        H[f] = np.triu(cplx(n, n))
        d = np.diagonal(H[f]).copy()
        np.fill_diagonal(H[f], d / np.abs(d) * (1.0 + rng.random(n)))
    Z = np.stack([np.linalg.qr(cplx(n, n))[0] for _ in range(p)])
    f, g = cplx(2)
    d = np.hypot(abs(f), abs(g))
    cs = np.array([abs(f) / d, (f / abs(f)) * np.conj(g) / d])
    return H, Z, cs


def cx_recon_err(H0, Z0, H, Z, S):
    """max over factors of max|Z H Z^H - Z0 H0 Z0^H| (signature-aware),
    relative to max|H0|."""
    p = H0.shape[0]
    worst = 0.0
    for l in range(p):
        a, b = (l, (l + 1) % p) if S[l] else ((l + 1) % p, l)
        A = Z0[a] @ H0[l] @ Z0[b].conj().T
        B = Z[a] @ H[l] @ Z[b].conj().T
        worst = max(worst, float((A - B).abs().max()))
    return worst / float(H0.abs().max())


def cx_kernel_phase(dev, p, n, report):
    """Kernels S, A -> B0 -> B against the plain versions, alternating S.

    1. The sweep (A, B0, B through qz_sweep) against qz_sweep_plain on
       three windows; tolerance max(1e-12, 10 sens) as in sweep_phase.
    2. B0 and B against qz_apply_log_plain on kernel A's own log: 1e-13.
    3. Backward error of the kernel sweep <= 1e-13 max|H0|, exact
       structural zeros, H[0]'s columns left of the window untouched.
    4. want_z=False leaves H identical.
    5. S against qz_shift_plain within 1e-14 relative, for an all-direct
       and an alternating signature.
    """
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, sweep_cx
    S = alternating(p)
    rng = np.random.default_rng(2025)
    Hn, Zn, csn = mk_cx_problem(p, n, rng)
    windows = [(0, n - 1), (37, min(200, n - 2)), (min(120, n - 3), min(122, n - 1))]
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    cs = torch.tensor(csn, device=dev)
    err_a = err_b = 0.0
    times = {}
    for (m, i) in windows:
        H0 = torch.tensor(Hn, device=dev)
        if m > 0:
            H0[0, m, m - 1] = 0.0       # the window's boundaries are deflated
        if i + 1 < n:
            H0[0, i + 1, i] = 0.0
        Z0 = torch.tensor(Zn, device=dev)
        scale = float(H0.abs().max())
        Hk, Zk = H0.clone(), Z0.clone()
        sweep_cx.qz_sweep(Hk, Zk, m, i, cs, S, want_z=True)
        Hp, Zp = H0.clone(), Z0.clone()
        t_plain = wall_ms(lambda: sweep_cx.qz_sweep_plain(Hp, Zp, m, i, cs, S,
                                                          want_z=True))
        pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
            Hn.shape), device=dev)
        Hq, Zq = H0 * pert, Z0.clone()
        sweep_cx.qz_sweep_plain(Hq, Zq, m, i, cs, S, want_z=True)
        sens_h = float((Hq - Hp).abs().max()) / scale
        sens_z = float((Zq - Zp).abs().max())
        dh = float((Hk - Hp).abs().max()) / scale
        dz = float((Zk - Zp).abs().max())
        tol_h, tol_z = max(TOL, 10 * sens_h), max(TOL, 10 * sens_z)
        # 2. the apply kernels on kernel A's own log (A reads H0 only)
        H0c = H0.clone()
        log = sweep_cx.qz_sweep_generate(H0, m, i, cs, S)
        if not torch.equal(H0, H0c):
            raise AssertionError("cx kernel A wrote its input")
        Hb, Zb = H0.clone(), Z0.clone()
        _cuda.check(lib.psd_qz_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i,
                                          st), "qz_sweep_left")
        h_b0 = sha(Hb)
        _cuda.check(lib.psd_qz_sweep_right(Hb.data_ptr(), Zb.data_ptr(),
                                           log.data_ptr(), p, n, m, i, st),
                    "qz_sweep_right")
        _log(f"cx B0/B window [{m}, {i}] (sha256 prefixes, equal across versions when bit "
             f"for bit): H after B0 {h_b0}, after B {sha(Hb)}, Z after B {sha(Zb)}")
        Ha, Za = H0.clone(), Z0.clone()
        t_apply = wall_ms(lambda: sweep_cx.qz_apply_log_plain(Ha, Za, log, m, i,
                                                              want_z=True))
        db = max(float((Hb - Ha).abs().max()) / scale, float((Zb - Za).abs().max()))
        be_k = cx_recon_err(H0, Z0, Hk, Zk, S)
        be_p = cx_recon_err(H0, Z0, Hp, Zp, S)
        _log(f"cx sweep window [{m}, {i}]: vs qz_sweep_plain max|dH|/max|H| {dh:.3e} "
             f"max|dZ| {dz:.3e} (plain's own 1e-16 sensitivity {sens_h:.3e} / "
             f"{sens_z:.3e}; tolerance {tol_h:.3e} / {tol_z:.3e}); B0+B vs "
             f"qz_apply_log_plain {db:.3e}; backward error kernel {be_k:.3e} plain "
             f"{be_p:.3e}; plain sweep {t_plain:.1f} ms, plain apply {t_apply:.1f} ms")
        if not (dh <= tol_h and dz <= tol_z):
            raise AssertionError(f"cx sweep kernels disagree with qz_sweep_plain on "
                                 f"[{m}, {i}]: {dh:.3e} {dz:.3e}")
        if not db <= 1e-13:
            raise AssertionError(f"cx B0/B disagree with qz_apply_log_plain on [{m}, {i}]")
        if not torch.equal(Hb, Hk) or not torch.equal(Zb, Zk):
            raise AssertionError("the cx wrapper and the direct kernel calls differ")
        if not be_k <= 1e-13:
            raise AssertionError(f"cx sweep backward error {be_k:.3e} on [{m}, {i}]")
        if not (structure_ok(Hk) and structure_ok(Hp)):
            raise AssertionError(f"cx sweep [{m}, {i}]: structural zeros not exact")
        if not torch.equal(Hk[0, :, :m], H0[0, :, :m]):
            raise AssertionError(f"cx sweep [{m}, {i}] touched H[0] left of the window")
        err_a = max(err_a, dh, dz)
        err_b = max(err_b, db)
        if (m, i) == windows[0]:
            times["plain_sweep"], times["plain_apply"] = t_plain, t_apply
        if (m, i) == windows[1]:
            Hnz = H0.clone()
            sweep_cx.qz_sweep(Hnz, None, m, i, cs, S, want_z=False)
            if not torch.equal(Hnz, Hk):
                raise AssertionError("cx want_z=False sweep changed H")
            _log("cx sweep want_z=False: H identical to want_z=True")

    # the want_t=False bound on kernel A's log: rlo = m = 37 (odd, off B's
    # 16-row tiles) and rlo = 21 < m, chi = i + 1
    for (m, i, rlo) in ((37, 200, 37), (120, 180, 21)):
        H0 = torch.tensor(Hn, device=dev)
        H0[0, m, m - 1] = 0.0
        H0[0, i + 1, i] = 0.0
        d, _ = apply_bound_case(dev, "cx", H0, torch.tensor(Zn, device=dev),
                                sweep_cx.qz_sweep_generate(H0, m, i, cs, S), m, i, rlo, i + 1)
        err_b = max(err_b, d)

    # 5. kernel S against qz_shift_plain
    H = torch.tensor(Hn, device=dev)
    err_s = 0.0
    for Ssh in ((True,) * p, S):
        for (a, b) in windows:
            ck = sweep_cx.qz_shift(H, a, b, Ssh)
            cp = sweep_cx.qz_shift_plain(H, a, b, Ssh)
            e = float((ck - cp).abs().max()) / max(float(cp.abs().max()), 1e-300)
            err_s = max(err_s, e)
    _log(f"cx shift kernel vs qz_shift_plain: max relative difference {err_s:.3e}")
    if not err_s <= 1e-14:
        raise AssertionError(f"cx shift kernel disagrees: {err_s:.3e}")
    out = torch.empty(2, dtype=torch.complex128, device=dev)
    Sall = torch.tensor([int(x) for x in S], dtype=torch.int32, device=dev)
    m, i = windows[0]
    ms_s = event_ms(lambda: _cuda.check(lib.psd_qz_shift(
        H.data_ptr(), out.data_ptr(), Sall.data_ptr(), p, n, m, i, st), "qz_shift"), 20)
    t_shift_plain = wall_ms(lambda: sweep_cx.qz_shift_plain(H, m, i, S))

    # per-kernel times at the full window [0, n-1]
    Z = torch.tensor(Zn, device=dev)
    got = {}
    ms_a = event_ms(lambda: got.update(log=sweep_cx.qz_sweep_generate(H, m, i, cs, S)), 5)
    log = got["log"]
    ms_b0 = event_ms(lambda: _cuda.check(lib.psd_qz_sweep_left(
        H.data_ptr(), log.data_ptr(), p, n, m, i, st), "qz_sweep_left"), 5)
    ms_b = event_ms(lambda: _cuda.check(lib.psd_qz_sweep_right(
        H.data_ptr(), Z.data_ptr(), log.data_ptr(), p, n, m, i, st),
        "qz_sweep_right"), 5)
    _log(f"cx kernels at p={p} n={n} window [0, {n - 1}]: A {ms_a:.3f} ms "
         f"({ms_a * 1e3 / ((i - m) * p):.4f} us per (step, factor)), B0 "
         f"{ms_b0:.3f} ms, B {ms_b:.3f} ms, S {ms_s:.4f} ms; plain sweep "
         f"{times['plain_sweep']:.1f} ms, plain apply (B0+B) {times['plain_apply']:.1f} "
         f"ms, plain shift {t_shift_plain:.2f} ms")
    # bytes and operations of the window [0, n-1] (K steps), complex128
    # (16 B); a complex 2x2 application is 28 flops per entry pair.  A reads
    # what its generations depend on once, rows m..i and columns up to i on
    # and above the subdiagonal of H[0] and the diagonal of H[1:], and
    # writes 12 log entries per (factor, step) and r of factor 0; its left
    # rotations reach column i
    K = i - m
    upper = sum(i + 1 - max(r - 1, m) for r in range(m, i + 1)) + \
        (p - 1) * sum(i + 1 - r for r in range(m, i + 1))
    bounds = {
        "qz_sweep_generate": bound(16 * upper + 16 * (12 * p + 1) * K,
                                   28 * p * sum(i + 1 - k for k in range(m, i))),
        **cx_apply_bounds(p, n, m, i),
        "qz_shift": bound(16 * (2 * p + 1) + 32, 60 * p)}
    src = "periodicschurdecompositions_jl_torch/csrc/sweep_cx.cu"
    rep = "periodicschurdecompositions_jl_tpu/ops/pallas_sweep_cx.py:"
    for name, ms, line, err, pms in (
            ("qz_sweep_generate", ms_a, 295, err_a, times["plain_sweep"]),
            ("qz_sweep_left", ms_b0, 507, err_b, times["plain_apply"]),
            ("qz_sweep_right", ms_b, 549, err_b, times["plain_apply"]),
            ("qz_shift", ms_s, 771, err_s, t_shift_plain)):
        report[name] = {"name": name, "route": "cuda", "source": src,
                        "replaces": f"{rep}{line}", "max_abs_err": err, "ms": ms,
                        "plain_ms": pms, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1], "library_ms": None}


@contextlib.contextmanager
def counted_rereductions():
    """Counts the signed window re-reductions of the AED analyses that
    launch the stage-2 kernel (``ops/aed.py::_phess_window_signed``: one
    ``phessenberg_signed_core`` each, with one stage-2 launch at n > 2)."""
    from periodicschurdecompositions_jl_torch.ops import aed
    seen = {"n": 0}
    reduce = aed._phess_window_signed

    def counted(Aw, *a, **k):
        seen["n"] += Aw.shape[-1] > 2
        return reduce(Aw, *a, **k)
    aed._phess_window_signed = counted
    try:
        yield seen
    finally:
        aed._phess_window_signed = reduce


def aed_line(info):
    return (f"AED: {info['aed_events']} events, {info['aed_hits']} deflating, aed_deflated "
            f"{info['aed_deflated']}, host_tail_finished {info['host_tail_finished']}, "
            f"aed_s {info['aed_s']:.3f} s of host analysis")


def check_aed_leg(info, vals, ref_values, what):
    """A default (AED) leg: AED must have fired and deflated, and its
    eigenvalues lie within 1000 eps max|lambda| of the AED-off leg's."""
    ev = eig_dist(vals, ref_values) / np.abs(ref_values).max()
    _log(f"{what}: eigenvalues vs the AED-off leg {ev:.3e} max|lambda|")
    if not (info["aed_events"] > 0 and info["aed_deflated"] > 0):
        raise AssertionError(f"{what}: AED {info['aed_events']} events, deflated "
                             f"{info['aed_deflated']}: both must be > 0")
    if not ev <= 1000 * np.finfo(np.float64).eps:
        raise AssertionError(f"{what}: eigenvalues differ from the AED-off leg's by {ev:.3e}")


def leg_profile(tag, run):
    """torch.profiler (device activity only) over one more run of a leg:
    wall, device busy time, idle share and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _log(f"profile of {tag}: {profile_line(prof, wall)}")


def cx_draw(p, n, seed):
    """The complex legs' draw (benchmarks/probe_complex_ff.py:35-36)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n))


def check_deflate_launches(launches, info, where):
    """Each deflation action an iteration took is one launch of its kernel."""
    for key, taken in (("deflate_czshift", info["czshift"]),
                       ("deflate_pos", info["deflate_pos"]),
                       ("deflate_neg", info["deflate_neg"])):
        if launches[key] != taken:
            raise AssertionError(f"{key} launched {launches[key]} times for {taken} "
                                 f"actions on {where}")


def cx_backerr(A, T, Z, S, left=False):
    """max_l max|Ahat - A| / max|A| with the signature and orientation."""
    p = T.shape[0]
    worst = 0.0
    scale = np.abs(A).max()
    for l in range(p):
        ln = (l + 1) % p
        Ax = (Z[l] @ T[l] @ Z[ln].conj().T if bool(S[l]) ^ left
              else Z[ln] @ T[l] @ Z[l].conj().T)
        worst = max(worst, np.abs(Ax - A[l]).max() / scale)
    return worst


def cx_e2e_case(dev, p, n, seed, S, lr, aed_off=False, ref_values=None):
    """pschur on a complex cycle through the public entry point (the
    default configuration: AED from n = 192 and the host tail), or with
    ``aed_off`` through ``pschur_complex_pipeline(..., cfg=AlgoConfig(aed=
    False, host_tail=-1))``.  ``ref_values``: the AED-off leg's eigenvalues
    of the same cycle; the leg must then have run AED (check_aed_leg), and
    one more run of it is profiled (its idle share) after the counts are
    read.  Returns the launch counts and the eigenvalues."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import (hessenberg, pqz_complex, pqz_deflate,
                                                         sweep_cx)
    A = cx_draw(p, n, seed)
    At = torch.tensor(A, device=dev)
    Sg = (True,) * p if S is None else S
    for d in (sweep_cx.launches, hessenberg.launches, pqz_deflate.launches):
        for k in d:
            d[k] = 0
    with counted_rereductions() as rered:
        t0 = time.perf_counter()
        if aed_off:
            P = pqz_complex.pschur_complex_pipeline(At, Sg, lr, cfg=AlgoConfig(
                aed=False, host_tail=-1))
        else:
            P = pt.pschur(At, lr, S=S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {**sweep_cx.launches, "hess_reduce_c128": hessenberg.launches["hess_reduce"],
                "hess_signed_c128": hessenberg.launches["hess_signed"]}
    info = dict(pqz_complex.last_info)
    deflate_launches = dict(pqz_deflate.launches)
    T = P.Ts.cpu().numpy()
    Z = P.Zs.cpu().numpy()
    ok, rep = pt.check_psd(P, A, tol=200.0)
    be = cx_backerr(A, T, Z, Sg, left=(lr == "L"))
    orth_bound = 10 * np.finfo(np.float64).eps * n
    vals = P.values.cpu().numpy()
    tag = ("pschur_complex_pipeline aed=False host_tail=-1" if aed_off
           else "pschur complex (default)")
    _log(f"{tag} p={p} n={n} seed={seed} S={'None' if S is None else 'alternating'} "
         f"lr={lr}: wall {wall:.3f} s (reduction {info['reduce_s']:.3f} s, iteration "
         f"{info['iterate_s']:.3f} s), niter {info['niter']}, sweeps {info['sweeps']}, "
         f"exceptional {info['exceptional']}, czshift {info['czshift']}, backerr {be:.3e}, "
         f"check_psd ok={ok} orth {rep['orthonormality']:.3e} (bound {orth_bound:.3e}) "
         f"residual {rep['residual_rel']:.3e}; {aed_line(info)}, window re-reductions "
         f"{rered['n']}; launches {launches}, {deflate_launches}")
    if not ok:
        raise AssertionError(f"check_psd failed: {rep}")
    if not (be <= 1e-12):
        raise AssertionError(f"backward error {be:.3e} > 1e-12")
    if not (rep["orthonormality"] <= orth_bound):
        raise AssertionError("orthonormality above 10 eps n")
    if not (np.all(np.isfinite(vals)) and vals.shape == (n,)):
        raise AssertionError("eigenvalues not finite or of the wrong shape")
    if ref_values is not None:
        check_aed_leg(info, vals, ref_values, tag)
        leg_profile(f"one more {tag} run", lambda: pt.pschur(At, lr, S=S))
        _log(f"  (that run: niter {pqz_complex.last_info['niter']}, "
             f"{aed_line(pqz_complex.last_info)})")
    check_deflate_launches(deflate_launches, info, "the complex path")
    # the reduction kernel runs once when every factor is direct; a signature
    # takes the signed reduction, whose stage 2 is one launch; each AED
    # window's re-reduction is one more signed reduction
    expect = {"hess_reduce_c128": 1 if S is None else 0,
              "hess_signed_c128": (0 if S is None else 1) + rered["n"]}
    for k, v in launches.items():
        if (v != expect[k]) if k in expect else v <= 0:
            raise AssertionError(f"kernel {k} launched {v} times on the complex path")
    launches["deflate_czshift_c128"] = deflate_launches["deflate_czshift"]
    return launches, vals


def cx_iteration_profile(dev, p, n, seed):
    """torch.profiler over the complex iteration of the p x n leg (the same
    draw, reduced once more): wall, device busy time, idle share, and the
    device time of the top kernels.  Runs after the leg's counters are
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_core
    from periodicschurdecompositions_jl_torch.ops.pqz_complex import pqz_complex_core
    H, Q = phessenberg_core(torch.tensor(cx_draw(p, n, seed), device=dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pqz_complex_core(H, (True,) * p, Z=Q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _log(f"profile of the complex iteration p={p} n={n}: {profile_line(prof, wall)}")


def cx_small_check(dev):
    """A small signed complex cycle on the card: eigenvalues against numpy's
    eigvals of the signed product."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    rng = np.random.default_rng(4)
    S = (True, False, True)
    A = rng.standard_normal((3, 10, 10)) + 1j * rng.standard_normal((3, 10, 10))
    P = pt.pschur(torch.tensor(A, device=dev), "R", S=S)
    ok, _ = pt.check_psd(P, A)
    w = np.sort_complex(P.values.cpu().numpy())
    ref = np.sort_complex(np.linalg.eigvals(A[0] @ np.linalg.inv(A[1]) @ A[2]))
    err = np.abs(w - ref).max() / np.abs(ref).max()
    _log(f"small signed complex check p=3 n=10 S={S}: eigenvalue error {err:.3e}, ok={ok}")
    if not (ok and err < 1e-10):
        raise AssertionError("small signed complex check failed")


# ---------------------------------------------------------------------------
# real generalized periodic QZ


def mk_rg_problem(p, n, rng):
    """Real Hessenberg-triangular cycle (triangular diagonals of modulus in
    [1, 2), the reason of mk_sweep_problem's), orthogonal Z and the opening
    rotations (c1, s1, c2, s2)."""
    H = np.zeros((p, n, n))
    H[0] = np.triu(rng.standard_normal((n, n)), -1)
    for f in range(1, p):
        H[f] = np.triu(rng.standard_normal((n, n)))
        d = rng.standard_normal(n)
        np.fill_diagonal(H[f], np.where(d >= 0, 1.0, -1.0) * (1.0 + rng.random(n)))
    Z = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(p)])
    rot = []
    for f, g in rng.standard_normal((2, 2)):
        d = np.hypot(f, g)
        rot += [abs(f) / d, np.sign(f) * g / d]
    return H, Z, np.array(rot)


def rg_structure_ok(H, i):
    """Exact structural zeros of a chase's output, apart from the closing
    bulge H[0][i, i-2] (which must be there)."""
    Hn = H.cpu().numpy()
    H0 = Hn[0].copy()
    if H0[i, i - 2] == 0:
        return False
    H0[i, i - 2] = 0.0
    return bool(np.all(np.tril(H0, -2) == 0)
                and all(np.all(np.tril(Hn[f], -1) == 0) for f in range(1, Hn.shape[0])))


def rg_upper(p, lo, hi, clast):
    """Entries of rows lo..hi, columns up to clast, that are not structural
    zeros after the rg opening: from column r-1 in H[0] (plus the opening's
    three bulge entries) and from column r in the other factors."""
    rows = range(lo, hi + 1)
    return (sum(clast + 2 - max(r, lo) for r in rows) + 3
            + (p - 1) * sum(max(clast + 1 - r, 0) for r in rows))


def rg_apply_bounds(p, n, m, i):
    """Bounds of rg B0 (``rg_sweep_left``) and rg B (``rg_sweep_right``) on
    the window [m, i] (K = i-1-m steps), float64, counting the entries that
    are not structural zeros.  B0 reads the upper parts of rows m..i and
    the log's L, and writes those rows, which it fills from column m-1 in
    H[0] and from column m in the others, a 3x3 application being 15 flops
    per entry triple.  B reads and writes columns m..i of H's rows 0..i and
    of all of Z, and reads R and ZR."""
    K = i - 1 - m
    return {"rg_sweep_left": bound(8 * rg_upper(p, m, i, n - 1)
                                   + 8 * (i + 1 - m) * (p * (n - m) + 1) + 8 * 9 * p * K,
                                   15 * p * (n - m + 1) * K),
            "rg_sweep_right": bound(2 * 8 * p * (i + 1 + n) * (i + 1 - m) + 8 * 18 * p * K,
                                    15 * p * (i + 1 + n) * K)}


def rg_apply_odd_n(dev, lib, st):
    """rg B0 and B at an odd n (p=3 n=129, alternating S: rows that are not
    16-byte aligned, ragged tiles and chunks) on the full window [1, 128]
    and a one-step one [60, 62], on kernel rg A's log, against
    rg_apply_log_plain: 1e-13, exact structural zeros with the closing
    bulge kept, the regenerated r exact, and without Z the same H.
    Returns the largest difference."""
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, rgopen, sweep_rg
    p, n = 3, 129
    S = alternating(p)
    Hn, Zn, rotn = mk_rg_problem(p, n, np.random.default_rng(2026))
    err = 0.0
    for (m, i) in ((1, n - 1), (60, 62)):
        H0, Z0 = torch.tensor(Hn, device=dev), torch.tensor(Zn, device=dev)
        if m > 1:
            H0[0, m - 1, m - 2] = 0.0
        if i + 1 < n:
            H0[0, i + 1, i] = 0.0
        rgopen.rg_ladder_plain(H0, Z0, "open", m - 1, i, torch.tensor(rotn, device=dev), S,
                               want_z=True)
        log = sweep_rg.rg_sweep_generate(H0, m, i, S)
        Ha, Za = H0.clone(), Z0.clone()
        sweep_rg.rg_apply_log_plain(Ha, Za, log, m, i, want_z=True)
        Hs = []
        for Z in (Z0.clone(), None):
            Hb = H0.clone()
            _cuda.check(lib.psd_rg_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, st),
                        "rg_sweep_left")
            _cuda.check(lib.psd_rg_sweep_right(Hb.data_ptr(), None if Z is None else
                                               Z.data_ptr(), log.data_ptr(), p, n, m, i, st),
                        "rg_sweep_right")
            Hs.append((Hb, Z))
        (Hb, Zb), (Hnz, _) = Hs
        e = max(float((Hb - Ha).abs().max()) / float(H0.abs().max()),
                float((Zb - Za).abs().max()))
        err = max(err, e)
        r = torch.arange(m, i - 1, device=dev)
        if not (torch.equal(Hnz, Hb) and rg_structure_ok(Hb, i)
                and torch.equal(Hb[0, r, r - 1], log[0, m:i - 1, 27])
                and torch.equal(Hb[:, :, :m - 1], H0[:, :, :m - 1])):
            raise AssertionError(f"rg B0/B at p={p} n={n} [{m}, {i}]: structure, logged r "
                                 f"or the run without Z wrong")
        _log(f"rg B0/B at p={p} n={n} window [{m}, {i}] vs rg_apply_log_plain: {e:.3e}; "
             f"H after B {sha(Hb)}")
    if not err <= 1e-13:
        raise AssertionError(f"rg B0/B disagree with rg_apply_log_plain at n={n}: {err:.3e}")
    return err


def rg_kernel_phase(dev, p, n, report):
    """Kernels rg A -> B0 -> B and R against the plain versions, alternating S.

    1. The chase (rg A, B0, B through rg_chase) against rg_chase_plain, on
       the state the opening leaves, on the full window and two interior
       ones; tolerance max(1e-12, 10 sens) as in sweep_phase.
    2. B0 and B against rg_apply_log_plain on kernel A's own log: 1e-13.
    3. Backward error of the kernel chase <= 1e-13 max|H0|, exact
       structural zeros apart from the closing bulge, H[0]'s columns left
       of the bulge column untouched, want_z=False leaves H identical.
    4. R in its three modes (and with want_t=False bounds) against
       rg_ladder_plain: 1e-13 max|H|, the same exact zeros.
    """
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, rgopen, sweep_rg
    S = alternating(p)
    rng = np.random.default_rng(2026)
    Hn, Zn, rotn = mk_rg_problem(p, n, rng)
    windows = [(1, n - 1), (38, min(200, n - 2)), (min(121, n - 4), min(124, n - 2))]
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    rot = torch.tensor(rotn, device=dev)
    Sd = torch.tensor([int(x) for x in S], dtype=torch.int32, device=dev)
    err_a = err_b = 0.0
    times = {}
    for (m, i) in windows:
        H0 = torch.tensor(Hn, device=dev)
        if m > 1:
            H0[0, m - 1, m - 2] = 0.0   # the window's boundaries are deflated
        if i + 1 < n:
            H0[0, i + 1, i] = 0.0
        Z0 = torch.tensor(Zn, device=dev)
        rgopen.rg_ladder_plain(H0, Z0, "open", m - 1, i, rot, S, want_z=True)
        scale = float(H0.abs().max())
        Hk, Zk = H0.clone(), Z0.clone()
        sweep_rg.rg_chase(Hk, Zk, m, i, S, want_z=True)
        Hp, Zp = H0.clone(), Z0.clone()
        t_plain = wall_ms(lambda: sweep_rg.rg_chase_plain(Hp, Zp, m, i, S, want_z=True))
        pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
            Hn.shape), device=dev)
        Hq, Zq = H0 * pert, Z0.clone()
        sweep_rg.rg_chase_plain(Hq, Zq, m, i, S, want_z=True)
        sens_h = float((Hq - Hp).abs().max()) / scale
        sens_z = float((Zq - Zp).abs().max())
        dh = float((Hk - Hp).abs().max()) / scale
        dz = float((Zk - Zp).abs().max())
        tol_h, tol_z = max(TOL, 10 * sens_h), max(TOL, 10 * sens_z)
        # 2. the apply kernels on kernel A's own log (A reads H0 only)
        H0c = H0.clone()
        log = sweep_rg.rg_sweep_generate(H0, m, i, S)
        if not torch.equal(H0, H0c):
            raise AssertionError("rg kernel A wrote its input")
        Hb, Zb = H0.clone(), Z0.clone()
        _cuda.check(lib.psd_rg_sweep_left(Hb.data_ptr(), log.data_ptr(), p, n, m, i, st),
                    "rg_sweep_left")
        h_b0 = sha(Hb)
        _cuda.check(lib.psd_rg_sweep_right(Hb.data_ptr(), Zb.data_ptr(), log.data_ptr(),
                                           p, n, m, i, st), "rg_sweep_right")
        _log(f"rg B0/B window [{m}, {i}] (sha256 prefixes, equal across versions when bit "
             f"for bit): H after B0 {h_b0}, after B {sha(Hb)}, Z after B {sha(Zb)}")
        Ha, Za = H0.clone(), Z0.clone()
        t_apply = wall_ms(lambda: sweep_rg.rg_apply_log_plain(Ha, Za, log, m, i,
                                                              want_z=True))
        db = max(float((Hb - Ha).abs().max()) / scale, float((Zb - Za).abs().max()))
        be_k = cx_recon_err(H0, Z0, Hk, Zk, S)
        be_p = cx_recon_err(H0, Z0, Hp, Zp, S)
        _log(f"rg chase window [{m}, {i}]: vs rg_chase_plain max|dH|/max|H| {dh:.3e} "
             f"max|dZ| {dz:.3e} (plain's own 1e-16 sensitivity {sens_h:.3e} / "
             f"{sens_z:.3e}; tolerance {tol_h:.3e} / {tol_z:.3e}); B0+B vs "
             f"rg_apply_log_plain {db:.3e}; backward error kernel {be_k:.3e} plain "
             f"{be_p:.3e}; plain chase {t_plain:.1f} ms, plain apply {t_apply:.1f} ms")
        if not (dh <= tol_h and dz <= tol_z):
            raise AssertionError(f"rg kernels disagree with rg_chase_plain on "
                                 f"[{m}, {i}]: {dh:.3e} {dz:.3e}")
        if not db <= 1e-13:
            raise AssertionError(f"rg B0/B disagree with rg_apply_log_plain on [{m}, {i}]")
        if not torch.equal(Hb, Hk) or not torch.equal(Zb, Zk):
            raise AssertionError("the rg wrapper and the direct kernel calls differ")
        if not be_k <= 1e-13:
            raise AssertionError(f"rg chase backward error {be_k:.3e} on [{m}, {i}]")
        if not (rg_structure_ok(Hk, i) and rg_structure_ok(Hp, i)):
            raise AssertionError(f"rg chase [{m}, {i}]: structural zeros not exact")
        if not torch.equal(Hk[0, :, :m - 1], H0[0, :, :m - 1]):
            raise AssertionError(f"rg chase [{m}, {i}] touched H[0] left of the bulge")
        err_a = max(err_a, dh, dz)
        err_b = max(err_b, db)
        if (m, i) == windows[0]:
            times["plain_chase"], times["plain_apply"] = t_plain, t_apply
        if (m, i) == windows[1]:
            Hnz = H0.clone()
            sweep_rg.rg_chase(Hnz, None, m, i, S, want_z=False)
            if not torch.equal(Hnz, Hk):
                raise AssertionError("rg want_z=False chase changed H")
            _log("rg chase want_z=False: H identical to want_z=True")

    err_b = max(err_b, rg_apply_odd_n(dev, lib, st))
    # the want_t=False bound on kernel A's log, on the state the opening
    # leaves: rlo = m - 1 = 37 (the sweep's first row; odd, off B's 16-row
    # tiles) and 11, chi = i + 1
    for (m, i, rlo) in ((38, 200, 37), (121, 180, 11)):
        H0 = torch.tensor(Hn, device=dev)
        H0[0, m - 1, m - 2] = 0.0
        H0[0, i + 1, i] = 0.0
        Z0 = torch.tensor(Zn, device=dev)
        rgopen.rg_ladder_plain(H0, Z0, "open", m - 1, i, rot, S, want_z=True, rhi=i + 1,
                               clo=m - 1)
        d, _ = apply_bound_case(dev, "rg", H0, Z0, sweep_rg.rg_sweep_generate(H0, m, i, S), m,
                                i, rlo, i + 1)
        err_b = max(err_b, d)

    # 4. kernel R against rg_ladder_plain
    H = torch.tensor(Hn, device=dev)
    Z = torch.tensor(Zn, device=dev)
    err_r = 0.0
    hashes = []
    spots = [("open", 0, n - 1), ("open", 37, 200), ("close", n - 2, n - 1),
             ("close", 199, 200), ("chain", 100, 101), ("chain", n - 2, n - 1)]
    for mode, j, il in spots:
        for bounds in ({}, {"rhi": il + 1, "clo": max(j - 5, 0)}):
            Hk, Zk = H.clone(), Z.clone()
            rgopen.rg_ladder(Hk, Zk, mode, j, il, rot, S, want_z=True, **bounds)
            Hp, Zp = H.clone(), Z.clone()
            rgopen.rg_ladder_plain(Hp, Zp, mode, j, il, rot, S, want_z=True, **bounds)
            e = max(float((Hk - Hp).abs().max()) / float(H.abs().max()),
                    float((Zk - Zp).abs().max()))
            err_r = max(err_r, e)
            Hz = H.clone()
            rgopen.rg_ladder(Hz, None, mode, j, il, rot, S, want_z=False, **bounds)
            if not torch.equal(Hz, Hk):
                raise AssertionError(f"rg ladder {mode} want_z=False changed H")
            if not torch.equal(Hk == 0, Hp == 0):
                raise AssertionError(f"rg ladder {mode} at {j}: exact zeros not the plain's")
            hashes.append(f"{mode} {j}{' bounded' if bounds else ''} {sha(Hk)} {sha(Zk)}")
    _log(f"rg ladder kernel vs rg_ladder_plain (open, close, chain; with and without "
         f"want_t=False bounds): max relative difference {err_r:.3e}, exact zeros the "
         f"plain version's; H, Z sha256 " + "; ".join(hashes))
    if not err_r <= 1e-13:
        raise AssertionError(f"rg ladder kernel disagrees: {err_r:.3e}")

    # per-kernel times at the full window [1, n-1] (the opening at 0)
    m, i = windows[0]
    H = torch.tensor(Hn, device=dev)
    rgopen.rg_ladder_plain(H, Z, "open", 0, i, rot, S, want_z=True)
    log = torch.empty((p, n, sweep_rg.LOG), dtype=torch.float64, device=dev)
    work = torch.empty(lib.psd_rg_sweep_generate_scratch(p, n), dtype=torch.float64,
                       device=dev)
    ms_a = event_ms(lambda: _cuda.check(lib.psd_rg_sweep_generate(
        H.data_ptr(), work.data_ptr(), log.data_ptr(), Sd.data_ptr(), p, n, m, i, st),
        "rg_sweep_generate"), 5)
    ms_b0 = event_ms(lambda: _cuda.check(lib.psd_rg_sweep_left(
        H.data_ptr(), log.data_ptr(), p, n, m, i, st), "rg_sweep_left"), 5)
    ms_b = event_ms(lambda: _cuda.check(lib.psd_rg_sweep_right(
        H.data_ptr(), Z.data_ptr(), log.data_ptr(), p, n, m, i, st), "rg_sweep_right"), 5)
    ms_r = event_ms(lambda: _cuda.check(lib.psd_rg_ladder(
        H.data_ptr(), Z.data_ptr(), rot.data_ptr(), Sd.data_ptr(), p, n, 0, 0, n - 1, n,
        0, st), "rg_ladder"), 20)
    t_ladder_plain = wall_ms(lambda: rgopen.rg_ladder_plain(H, Z, "open", 0, n - 1, rot, S,
                                                            want_z=True))
    _log(f"rg kernels at p={p} n={n} window [{m}, {i}]: A {ms_a:.3f} ms "
         f"({ms_a * 1e3 / ((i - 1 - m) * p):.4f} us per (step, factor)), B0 {ms_b0:.3f} ms, "
         f"B {ms_b:.3f} ms, R (open at 0) {ms_r:.4f} ms; plain chase "
         f"{times['plain_chase']:.1f} ms, plain apply (B0+B) {times['plain_apply']:.1f} ms, "
         f"plain ladder {t_ladder_plain:.2f} ms")
    # bytes and operations of the window (K steps j = m..i-2), float64, of
    # the entries that are not structural zeros.  A reads what its
    # generations depend on once: rows m..min(i+1, n-1) and columns up to i
    # (every such entry reaches a later generation: each left rotation
    # moves it two rows down), from column r-1 in H[0] (plus the opening's
    # three bulge entries) and from column r in the other factors, writes
    # the log (27 entries per (factor, step), one more for factor 0), and
    # applies two 2-row rotations per (step, factor) to columns j..i (12
    # flops per column).  Columns right of i never reach a generation (an
    # earlier count took them in; at the full window i = n-1 the two
    # agree).  B0 and B: rg_apply_bounds; R: ladder_bound.
    K = i - 1 - m
    bounds = {
        "rg_sweep_generate": bound(8 * rg_upper(p, m, min(i + 1, n - 1), i)
                                   + 8 * (27 * p + 1) * K,
                                   12 * p * sum(i + 1 - j for j in range(m, i - 1))),
        **rg_apply_bounds(p, n, m, i),
        "rg_ladder": ladder_bound(p, n)}
    src = "periodicschurdecompositions_jl_torch/csrc/"
    rep = "periodicschurdecompositions_jl_tpu/ops/"
    for name, ms, where, err, pms in (
            ("rg_sweep_generate", ms_a, "pallas_sweep_rg.py:182", err_a, times["plain_chase"]),
            ("rg_sweep_left", ms_b0, "pallas_sweep_rg.py:372", err_b, times["plain_apply"]),
            ("rg_sweep_right", ms_b, "pallas_sweep_rg.py:409", err_b, times["plain_apply"]),
            ("rg_ladder", ms_r, "pallas_rgopen.py:66", err_r, t_ladder_plain)):
        report[name] = {"name": name, "route": "cuda",
                        "source": src + ("rgopen.cu" if name == "rg_ladder" else "sweep_rg.cu"),
                        "replaces": rep + where, "max_abs_err": err, "ms": ms,
                        "plain_ms": pms, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1], "library_ms": None}


def rg_draw(p, n, seed):
    """The rg cell's draw (benchmarks/probe_real_gen_ff.py)."""
    return np.random.default_rng(seed).standard_normal((p, n, n)), alternating(p)


def rg_block_check(P):
    """Ties P's eigenvalues to T: T[0]'s subdiagonal is nonzero exactly at
    the first row k of each complex pair (alpha[k] with a positive imaginary
    part, alpha[k+1] its conjugate), never at two rows in a row, and the
    eigenvalues of each 1x1 or 2x2 diagonal block's signed product, formed
    on the host with numpy, are P.values there.  Raises on a structural
    fault; returns the largest relative eigenvalue difference."""
    T = P.Ts.cpu().numpy()
    alpha = P.alpha.cpu().numpy()
    vals = P.values.cpu().numpy()
    n = T.shape[-1]
    sub = np.diagonal(T[0], -1) != 0
    first = alpha.imag[:-1] > 0
    if not (np.array_equal(sub, first) and not np.any(sub[1:] & sub[:-1])
            and np.array_equal(alpha.imag[1:] < 0, first) and not alpha.imag[0] < 0
            and np.array_equal(alpha[1:][first], np.conj(alpha[:-1][first]))):
        raise AssertionError("T[0]'s 2x2 blocks and alpha's complex pairs disagree")
    err, k = 0.0, 0
    while k < n:
        w = 2 if k + 1 < n and sub[k] else 1
        M = np.eye(w)
        for l, s in enumerate(P.S):
            B = T[l][k:k + w, k:k + w]
            M = M @ (B if s else np.linalg.inv(B))
        ref = sorted(np.linalg.eigvals(M), key=lambda z: -z.imag)
        err = max(err, max(abs(g - r) / abs(r) for g, r in zip(vals[k:k + w], ref)))
        k += w
    return float(err)


def rg_e2e_case(dev, p, n, seed, aed_off=False, ref_values=None):
    """pschur(A, 'R', S) on a real cycle through the public entry point (the
    default configuration: AED from n = 192 and the host tail), or with
    ``aed_off`` through ``pschur_real_gen_pipeline(..., cfg=AlgoConfig(aed=
    False, host_tail=-1))``.  Returns the launch counts, the reduction (H,
    Q) the leg computed (kept for rg_iteration_profile) and the
    eigenvalues.  The signed reduction's stage 2 runs one launch of
    hess_signed for the cycle and one for each AED window re-reduction; the
    direct reduction kernel none.  The AED-off leg must take a controlled
    zero shift; ``ref_values``: the AED-off leg's eigenvalues, and the leg
    must have run AED (check_aed_leg); one more run of it is profiled (its
    idle share) after the counts are read."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import (hessenberg, pqz_deflate, pqz_real,
                                                         rgopen, sweep_rg)
    A, S = rg_draw(p, n, seed)
    At = torch.tensor(A, device=dev)
    counters = (sweep_rg.launches, rgopen.launches, hessenberg.launches,
                pqz_deflate.launches)
    kept = {}
    reduce = hessenberg.phessenberg_signed_core

    def keep(*a, **k):
        out = reduce(*a, **k)
        kept.setdefault("HQ", out)  # the cycle's: the first call
        return out
    hessenberg.phessenberg_signed_core = keep
    for d in counters:
        for k in d:
            d[k] = 0
    try:
        with counted_rereductions() as rered:
            t0 = time.perf_counter()
            if aed_off:
                P = pqz_real.pschur_real_gen_pipeline(At, S, "R", cfg=AlgoConfig(
                    aed=False, host_tail=-1))
            else:
                P = pt.pschur(At, "R", S=S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        hessenberg.phessenberg_signed_core = reduce
    launches = {k: v for d in counters[:3] for k, v in d.items()}
    deflate_launches = dict(pqz_deflate.launches)
    hess_reduce = launches.pop("hess_reduce")
    info = dict(pqz_real.last_info)
    T = P.Ts.cpu().numpy()
    Z = P.Zs.cpu().numpy()
    ok, rep = pt.check_psd(P, A, tol=200.0)
    scale = np.abs(A).max()
    per = []
    for l in range(p):
        ln = (l + 1) % p
        Ax = Z[l] @ T[l] @ Z[ln].T if S[l] else Z[ln] @ T[l] @ Z[l].T
        per.append(np.abs(Ax - A[l]).max() / scale)
    be = max(per)
    orth_bound = 10 * np.finfo(np.float64).eps * n
    vals = P.values.cpu().numpy()
    eig_err = rg_block_check(P)
    tag = ("pschur_real_gen_pipeline aed=False host_tail=-1" if aed_off
           else "pschur real S=alternating (default)")
    _log(f"{tag} p={p} n={n} seed={seed}: wall {wall:.3f} s (reduction "
         f"{info['reduce_s']:.3f} s, iteration {info['iterate_s']:.3f} s), niter "
         f"{info['niter']}, sweeps {info['sweeps']}, attacks {info['attacks']}, pairs "
         f"{info['pairs']}, exceptional {info['exceptional']}, czshift {info['czshift']}, "
         f"deflate_pos {info['deflate_pos']}, deflate_neg {info['deflate_neg']}; backerr "
         f"{be:.3e} (per factor {', '.join(f'{x:.2e}' for x in per)}), check_psd ok={ok} "
         f"orth {rep['orthonormality']:.3e} (bound {orth_bound:.3e}) residual "
         f"{rep['residual_rel']:.3e}; eigenvalues vs T's diagonal blocks {eig_err:.3e}; "
         f"{aed_line(info)}, window re-reductions {rered['n']}; "
         f"launches {launches}, {deflate_launches}")
    if not ok:
        raise AssertionError(f"check_psd failed: {rep}")
    if not (be <= 1e-12):
        raise AssertionError(f"backward error {be:.3e} > 1e-12")
    if not (rep["orthonormality"] <= orth_bound):
        raise AssertionError("orthonormality above 10 eps n")
    if not (np.all(np.isfinite(vals)) and vals.shape == (n,)):
        raise AssertionError("eigenvalues not finite or of the wrong shape")
    if not eig_err <= 1e-10:
        raise AssertionError(f"eigenvalues differ from T's diagonal blocks by {eig_err:.3e}")
    if ref_values is not None:
        check_aed_leg(info, vals, ref_values, tag)
        leg_profile(f"one more {tag} run", lambda: pt.pschur(At, "R", S=S))
        _log(f"  (that run: niter {pqz_real.last_info['niter']}, "
             f"{aed_line(pqz_real.last_info)})")
    for k, v in launches.items():
        if (v != 1 + rered["n"]) if k == "hess_signed" else v <= 0:
            raise AssertionError(f"kernel {k} launched {v} times on the real generalized path "
                                 f"({rered['n']} window re-reductions)")
    if hess_reduce != 0:
        raise AssertionError(f"the direct reduction kernel launched {hess_reduce} times on "
                             f"the real generalized path")
    check_deflate_launches(deflate_launches, info, "the real generalized path")
    if aed_off and deflate_launches["deflate_czshift"] <= 0:
        raise AssertionError("no controlled zero shift on the real generalized path")
    launches["deflate_czshift"] = deflate_launches["deflate_czshift"]
    return launches, kept["HQ"], vals


def want_t_legs(dev):
    """``pschur(..., want_t=False)`` (the eigenvalues-only mode: every
    update bounded to the active window) on the headline draw with Z and
    without it, on the complex leg's draw and on the rg leg's, each against
    the same call with T on this card, one after the other: the same
    niter, sweeps and AED tallies, the same kernel launches, and the
    eigenvalues and (with Z) Z bit for bit."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.ops import (deflate, glue, pqr_real, pqz_complex,
                                                         pqz_real, rgopen, sweep, sweep_cx,
                                                         sweep_rg)
    head = torch.tensor(np.random.default_rng(SEED_HEAD).standard_normal(
        (P_HEAD, N_HEAD, N_HEAD)), device=dev)
    An, S = rg_draw(P_RG, N_RG, SEED_RG)
    legs = (("real headline", pqr_real, (sweep, deflate, glue), head, None, True),
            ("real headline, want_z=False", pqr_real, (sweep, deflate, glue), head, None, False),
            ("complex leg", pqz_complex, (sweep_cx,),
             torch.tensor(cx_draw(P_CX, N_CX, SEED_CX), device=dev), None, True),
            ("rg leg", pqz_real, (sweep_rg, rgopen), torch.tensor(An, device=dev), S, True))
    keys = ("niter", "sweeps", "exceptional", "czshift", "aed_events", "aed_hits",
            "aed_deflated", "host_tail_finished")
    for tag, core, mods, A, Sg, wz in legs:
        runs = {}
        for want_t in (True, False):
            for mod in mods:
                for k in mod.launches:
                    mod.launches[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            P = pt.pschur(A, "R", S=Sg, want_t=want_t, want_z=wz)
            torch.cuda.synchronize()
            runs[want_t] = (P, dict(core.last_info), time.perf_counter() - t0,
                            {k: v for mod in mods for k, v in mod.launches.items()})
        (P1, i1, w1, l1), (P2, i2, w2, l2) = runs[True], runs[False]
        same = {"counts": all(i1[k] == i2[k] for k in keys if k in i1),
                "launches": l1 == l2, "values": torch.equal(P1.values, P2.values),
                "Z": not wz or torch.equal(P1.Zs, P2.Zs)}
        _log(f"want_t=False {tag}: wall {w2:.3f} s (with T {w1:.3f} s), niter {i2['niter']}, "
             f"{aed_line(i2)}; against the run with T: {same}; launches {l2}")
        if not all(same.values()):
            raise AssertionError(f"want_t=False {tag} differs from the run with T: {same}")
        if not np.all(np.isfinite(P2.values.cpu().numpy())):
            raise AssertionError(f"want_t=False {tag}: eigenvalues not finite")


def rg_czshift_check(dev, S, HQ):
    """Where the rg leg's kernel run parts from the plain one: the AED-off
    iteration from the leg's own reduction HQ (the leg's run), each CZSHIFT
    launch's output held against ``czshift_core_plain`` on a CPU copy of the
    same input, beside the plain version's own change when that input is
    perturbed by a relative 1e-16.  Prints one line per launch and the
    largest ratio; raises if a launch lies above max(1e-12, 10 sens) (as
    deflate_actions_phase's gate)."""
    import torch
    from periodicschurdecompositions_jl_torch.ops import pqz_deflate
    from periodicschurdecompositions_jl_torch.ops.pqz_real import pqz_real_gen_core
    H, Q = HQ
    rows = []
    launch = pqz_deflate.DeflateCores.czshift_core

    def checked(self, H, Z, jlo, ilast):
        Hc, Zc = H.cpu(), Z.cpu()
        out = launch(self, H, Z, jlo, ilast)
        Hp, Zp, fp = self.czshift_core_plain(Hc.clone(), Zc.clone(), jlo, ilast)
        pert = 1.0 + 1e-16 * torch.from_numpy(
            np.random.default_rng(len(rows)).standard_normal(tuple(Hc.shape)))
        Hs, Zs, _ = self.czshift_core_plain(Hc * pert, Zc.clone(), jlo, ilast)
        scale = float(Hp.abs().max())
        dh = float((H.cpu() - Hp).abs().max()) / scale
        dz = float((Z.cpu() - Zp).abs().max())
        sens = max(float((Hs - Hp).abs().max()) / scale, float((Zs - Zp).abs().max()))
        rows.append((jlo, ilast, dh, dz, sens, bool(out[2]) == bool(fp)))
        return out
    pqz_deflate.DeflateCores.czshift_core = checked
    try:
        _, _, _, _, _, _, ok, info = pqz_real_gen_core(H, S, Z=Q, with_info=True)
    finally:
        pqz_deflate.DeflateCores.czshift_core = launch
    worst = 0.0
    for jlo, ilast, dh, dz, sens, flag in rows:
        ratio = max(dh, dz) / max(sens, 1e-300)
        worst = max(worst, ratio)
        _log(f"rg CZSHIFT on [{jlo}, {ilast}]: kernel vs plain on a CPU copy max|dH|/max|H| "
             f"{dh:.3e} max|dZ| {dz:.3e}; the plain version's 1e-16 sensitivity {sens:.3e}; "
             f"same flag {flag}")
        if not (max(dh, dz) <= max(1e-12, 10 * sens) and flag):
            raise AssertionError(f"CZSHIFT on [{jlo}, {ilast}] parts from the plain version "
                                 f"beyond its sensitivity")
    _log(f"rg CZSHIFT check: {len(rows)} launches in {info['niter']} iterations (converged "
         f"{ok}), largest difference / sensitivity {worst:.3f}")


def rg_iteration_profile(dev, S, HQ):
    """torch.profiler (device activity only) over the real generalized
    iteration from the rg leg's own reduction HQ: wall, device busy time,
    idle share and the device time of the top kernels.  Runs after the
    leg's counters are read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from periodicschurdecompositions_jl_torch.ops.pqz_real import pqz_real_gen_core
    H, Q = HQ
    p, n, _ = H.shape
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pqz_real_gen_core(H, S, Z=Q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _log(f"profile of the real generalized iteration p={p} n={n}: "
         f"{profile_line(prof, wall)}")


def rg_small_check(dev):
    """A small real gpschur on the card (three pairs, a cycle of six):
    eigenvalues against numpy's eigvals of the formal product."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    rng = np.random.default_rng(5)
    As = [torch.tensor(a, device=dev) for a in rng.standard_normal((3, 10, 10))]
    Bs = [torch.tensor(b, device=dev) for b in rng.standard_normal((3, 10, 10))]
    P = pt.gpschur(As, Bs)
    An = [a.cpu().numpy() for a in As]
    Bn = [b.cpu().numpy() for b in Bs]
    M = np.eye(10)
    for a, b in zip(An, Bn):
        M = np.linalg.inv(b) @ a @ M
    w = np.sort_complex(P.values.cpu().numpy())
    ref = np.sort_complex(np.linalg.eigvals(M))
    err = np.abs(w - ref).max() / np.abs(ref).max()
    C = np.stack([An[2], Bn[1], An[1], Bn[0], An[0], Bn[2]])
    ok, _ = pt.check_psd(P, C, tol=32.0)
    _log(f"small real gpschur check p=3 pairs n=10: eigenvalue error {err:.3e}, ok={ok}")
    if not (ok and err < 1e-10):
        raise AssertionError("small real gpschur check failed")


# ---------------------------------------------------------------------------
# deflation actions (csrc/pqz_deflate.cu)


@contextlib.contextmanager
def rotation_work(cplx):
    """Counts, in a run of the plain deflation actions, the entries their
    2x2 updates touch (each read once and written once: bytes) and update
    (with repeats; a rotation's update of an entry is 3 real operations, a
    complex one 4x that), by wrapping the ``rowsk`` and ``colsk`` that
    ``ops/pqz_deflate.py`` calls.  Yields a dict that holds ``bytes`` and
    ``flops`` after the block."""
    from periodicschurdecompositions_jl_torch.ops import pqz_deflate
    from periodicschurdecompositions_jl_torch.ops.rotations import _clamp, _span
    masks, updated, out = {}, [0], {}
    rowsk, colsk = pqz_deflate.rowsk, pqz_deflate.colsk

    def mark(M, r0, r1, c0, c1):
        m = masks.setdefault(M.data_ptr(), np.zeros(M.shape, bool))
        m[r0:r1, c0:c1] = True
        updated[0] += (r1 - r0) * max(c1 - c0, 0)

    def rows(M, i, R, lo=None, hi=None):
        a, b = _span(lo, hi, M.shape[1])
        i = _clamp(i, 0, M.shape[0] - 2)
        mark(M, i, i + 2, a, b)
        return rowsk(M, i, R, lo, hi)

    def cols(M, j, R, lo=None, hi=None):
        a, b = _span(lo, hi, M.shape[0])
        j = _clamp(j, 0, M.shape[1] - 2)
        mark(M, a, b, j, j + 2)
        return colsk(M, j, R, lo, hi)
    pqz_deflate.rowsk, pqz_deflate.colsk = rows, cols
    try:
        yield out
    finally:
        pqz_deflate.rowsk, pqz_deflate.colsk = rowsk, colsk
    size = 16 if cplx else 8
    out["bytes"] = 2 * size * int(sum(m.sum() for m in masks.values()))
    out["flops"] = 3 * updated[0] * (4 if cplx else 1)


def cx_signed_reduction(dev):
    """The signed complex leg's reduction (p=8 n=128, alternating S)."""
    import torch
    from periodicschurdecompositions_jl_torch.ops import hessenberg
    A = torch.tensor(cx_draw(P_CX, N_CX_SIGNED, SEED_CX), device=dev)
    return hessenberg.phessenberg_signed_core(A, alternating(P_CX))


def pqz_deflate_cases(rg_hq, cx_hq):
    """(name, H, Z, action, args, zero) of deflate_actions_phase: the rg
    leg's reduction (float64, p=8 n=256) and the signed complex leg's
    (complex128, p=8 n=128), alternating S (factor 2 direct, 1, 3 and 5
    inverted).  args: CZSHIFT's window (jlo, ilast), else (jlo, ldef, jdef,
    ilast); zero: the diagonal entry (l, j) set to an exact zero, for
    DEFLATE_POS / DEFLATE_NEG the one they deflate, for CZSHIFT one of a
    direct factor inside the window (its fill is exactly zero: the identity
    branch, the flag set)."""
    out = []
    for kind, (H, Z), (w, zero_c, pos, down, up) in (
            ("real", rg_hq, ((37, 200), 101, 100, 180, 60)),
            ("complex", cx_hq, ((20, 100), 51, 50, 90, 30))):
        n = H.shape[1]
        out += [(f"{kind} czshift", H, Z, "czshift", (0, n - 1), None),
                (f"{kind} czshift", H, Z, "czshift", w, None),
                (f"{kind} czshift, zero", H, Z, "czshift", w, (2, zero_c)),
                (f"{kind} pos", H, Z, "pos", (0, 2, pos, n - 1), (2, pos)),
                (f"{kind} neg down", H, Z, "neg", (0, 1, down, n - 1), (1, down)),
                (f"{kind} neg up", H, Z, "neg", (0, 3, up, n - 1), (3, up))]
    # odd n (the complex rotations' storage stays 16-byte aligned): the
    # leading block of the complex reduction, still Hessenberg-triangular
    m = cx_hq[0].shape[1] - 1
    Ho, Zo = (t[:, :m, :m].contiguous() for t in cx_hq)
    out += [("complex czshift, odd n", Ho, Zo, "czshift", (0, m - 1), None),
            ("complex pos, odd n", Ho, Zo, "pos", (0, 2, 50, m - 1), (2, 50)),
            ("complex neg down, odd n", Ho, Zo, "neg", (0, 1, 90, m - 1), (1, 90))]
    return out


def deflate_actions_phase(dev, report, rg_hq):
    """The deflation actions (csrc/pqz_deflate.cu), float64 and complex128,
    against their plain versions on the card, on the states of
    pqz_deflate_cases.

    1. max|dH|/max|H| and max|dZ| within max(1e-12, 10 sens), sens being the
       plain version's change when H is perturbed by a relative 1e-16 (the
       chains of generations amplify rounding);
    2. every exact zero of the plain version's H kept, a zero of the
       kernel's alone only where the plain entry is within the tolerance (a
       fused product can round an entry that is zero in exact arithmetic to
       exactly 0), and the same CZSHIFT flag (set on the
       planted zero);
    3. one call adds one launch to its counter.
    Prints the kernel's time (CUDA events, the median of three calls on
    copies, through DeflateCores: Z's transposes and CZSHIFT's flag read
    included), the plain version's wall, and the bound of the work the
    plain run counts (rotation_work).  The report takes each action's first
    float64 case at p=8 n=256, and its first complex128 case at p=8 n=128
    (``deflate_*_c128``).
    """
    import torch
    from periodicschurdecompositions_jl_torch.ops import pqz_deflate
    S = alternating(P_RG)
    eps = float(np.finfo(np.float64).eps)
    worst = {}
    for name, H0, Z0, action, args, zero in pqz_deflate_cases(rg_hq, cx_signed_reduction(dev)):
        p, n, _ = H0.shape
        key = f"deflate_{action}"
        entry = key + ("_c128" if H0.is_complex() else "")
        H0 = H0.clone()
        if zero is not None:
            H0[zero[0], zero[1], zero[1]] = 0.0
        cores = pqz_deflate.DeflateCores(p, S, True, eps,
                                         float(np.finfo(np.float64).tiny) * n / eps)

        def run(route, H):
            H, Z = H.clone(), Z0.clone()
            out = getattr(cores, f"{action}_core{route}")(H, Z, *args)
            return H, Z, (out[2] if action == "czshift" else None)
        before = pqz_deflate.launches[key]
        Hk, Zk, fk = run("", H0)
        if pqz_deflate.launches[key] - before != 1:
            raise AssertionError(f"{name}: {pqz_deflate.launches[key] - before} launches "
                                 f"counted, 1 expected")
        res = {}
        t_plain = wall_ms(lambda: res.update(out=run("_plain", H0)))
        Hp, Zp, fp = res.pop("out")
        pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
            (p, n, n)), device=dev)
        with rotation_work(H0.is_complex()) as work:
            Hs, Zs, _ = run("_plain", H0 * pert)
        scale = float(H0.abs().max())
        sens = max(float((Hs - Hp).abs().max()) / scale, float((Zs - Zp).abs().max()))
        tol = max(1e-12, 10 * sens)
        dh = float((Hk - Hp).abs().max()) / scale
        dz = float((Zk - Zp).abs().max())
        ts = []
        for _ in range(3):
            Hc, Zc = H0.clone(), Z0.clone()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            getattr(cores, f"{action}_core")(Hc, Zc, *args)
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        ms = float(np.median(ts))
        bms, bby = bound(work["bytes"], work["flops"])
        _log(f"deflate {name} {args}: vs {action}_core_plain max|dH|/max|H| {dh:.3e} "
             f"max|dZ| {dz:.3e} (1e-16 sensitivity {sens:.3e}, tolerance {tol:.3e}); "
             f"zflag {fk} / plain {fp}; kernel {ms:.3f} ms (1 launch), plain "
             f"{t_plain:.1f} ms, bound {bms * 1e3:.3f} us ({bby}; {work['bytes']} bytes, "
             f"{work['flops']} flops)")
        if not (dh <= tol and dz <= tol):
            raise AssertionError(f"{key} disagrees with the plain version, {name}: "
                                 f"{dh:.3e} {dz:.3e}")
        zk, zp = Hk == 0, Hp == 0
        if not (bool(zk[zp].all()) and bool((Hp[zk & ~zp].abs() <= tol * scale).all())):
            raise AssertionError(f"{key} {name}: the plain version's exact zeros are not "
                                 f"kept, or a zero of the kernel alone is above rounding")
        if fk != fp or (zero is not None and action == "czshift" and not fk):
            raise AssertionError(f"{key} {name}: zflag {fk}, plain {fp}")
        worst[entry] = max(worst.get(entry, 0.0), dh, dz)
        if entry not in report:
            report[entry] = {
                "name": entry, "route": "cuda",
                "source": "periodicschurdecompositions_jl_torch/csrc/pqz_deflate.cu",
                # make_deflate_cores' jnp cores of the JAX package (no Pallas kernel)
                "replaces": "periodicschurdecompositions_jl_tpu/ops/pqz_deflate.py:"
                            + {"czshift": "454", "pos": "73", "neg": "266"}[action],
                "ms": ms, "plain_ms": t_plain, "bound_ms": bms, "bound_by": bby,
                "library_ms": None}
    for key, err in worst.items():
        report[key]["max_abs_err"] = err


def singular_cycle(kind, p, n, seed):
    """A cycle with alternating S whose reduction keeps exact zeros planted
    on the diagonals of factor 2 (direct) at n // 3 and factor 5 (inverted)
    at 2n // 3: every factor is A_l = R_l J, R_0 Hessenberg, R_l upper
    triangular, J the column reversal.  The signed reduction takes each
    inverted factor's RQ through the QR of A_l^H J = J R_l^H J, which is
    triangular, so every Householder reflection and every stage-2 rotation
    is diagonal and the reduced factors are the R_l up to diagonal
    unitaries, zeros included.  (A zero planted on a plain triangular
    factor does not survive that RQ: the reduction moves it.)"""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((p, n, n))
    if kind == "complex":
        R = R + 1j * rng.standard_normal((p, n, n))
    R = np.stack([np.triu(R[l], -1 if l == 0 else 0) for l in range(p)])
    R[2, n // 3, n // 3] = 0.0
    R[5, 2 * n // 3, 2 * n // 3] = 0.0
    return R[:, :, ::-1].copy()


def deflate_leg(dev):
    """The singular leg, DEFLATE_POS and DEFLATE_NEG on the main path:
    ``pschur(A, 'R', S)`` with alternating S on ``singular_cycle`` draws,
    real p=8 n=256 and complex p=8 n=127 (odd n).  Each run is checked by
    check_psd and its backward error, must take both actions, and each
    action it takes is one launch.  The counters are set to 0 just before
    each run and read just after; returns them (the complex run's under
    ``deflate_*_c128``)."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.ops import pqz_complex, pqz_deflate, pqz_real
    S = alternating(P_RG)
    out = {}
    for kind, n, core, tag in (("real", N_RG, pqz_real, ""),
                               ("complex", N_CX_SIGNED - 1, pqz_complex, "_c128")):
        A = singular_cycle(kind, P_RG, n, SEED_RG)
        At = torch.tensor(A, device=dev)
        for k in pqz_deflate.launches:
            pqz_deflate.launches[k] = 0
        t0 = time.perf_counter()
        P = pt.pschur(At, "R", S=S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pqz_deflate.launches)
        info = dict(core.last_info)
        ok, rep = pt.check_psd(P, A, tol=200.0)
        be = cx_backerr(A, P.Ts.cpu().numpy(), P.Zs.cpu().numpy(), S)
        _log(f"singular leg: pschur {kind} p={P_RG} n={n} (exact zeros on factor 2 at "
             f"{n // 3}, factor 5 at {2 * n // 3}): wall {wall:.3f} s, niter {info['niter']}, "
             f"sweeps {info['sweeps']}, czshift {info['czshift']}, deflate_pos "
             f"{info['deflate_pos']}, deflate_neg {info['deflate_neg']}, check_psd ok={ok}, "
             f"backerr {be:.3e}; launches {launches}")
        if not (ok and be <= 1e-12):
            raise AssertionError(f"singular leg {kind}: check_psd {rep}, backerr {be:.3e}")
        if not (info["deflate_pos"] >= 1 and info["deflate_neg"] >= 1):
            raise AssertionError(f"singular leg {kind}: DEFLATE_POS / DEFLATE_NEG not taken")
        check_deflate_launches(launches, info, f"the singular leg ({kind})")
        out.update({k + tag: v for k, v in launches.items()})
    return out


KRYLOV_P, KRYLOV_NEV, KRYLOV_SEED = 4, 4, 11
KRYLOV_N, KRYLOV_N_LARGE = 256, 4096
# tests/test_krylov.py::test_krylov_large_matrix_free (BASELINE config 5's scale)
KRYLOV_MF_P, KRYLOV_MF_N, KRYLOV_MF_NEV, KRYLOV_MF_SEED = 12, 10000, 5, 11


def krylov_draw(p, n, seed):
    """The draw of benchmarks/probe_krylov_chip.py:29-37 (numpy): a shared
    orthogonal q, A_l = q T_l q^T with T_l upper triangular, 0.05 upper
    noise and diagonal 1.02 ** arange(n); the product's eigenvalues are
    (1.02 ** arange(n)) ** p."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = []
    for _ in range(p):
        T = np.triu(rng.standard_normal((n, n)) * 0.05)
        np.fill_diagonal(T, 1.02 ** np.arange(n))
        A.append(q @ T @ q.T)
    return np.stack(A)


def krylov_draw_card(dev, p, n, seed):
    """The same construction made on the card from a seeded
    torch.Generator (q from torch.linalg.qr); its spectrum is the
    construction's, whatever q is."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = torch.float64
    q = torch.linalg.qr(torch.randn((n, n), generator=g, device=dev, dtype=f64))[0]
    d = 1.02 ** torch.arange(n, device=dev, dtype=f64)
    A = torch.empty((p, n, n), device=dev, dtype=f64)
    for l in range(p):
        T = torch.triu(torch.randn((n, n), generator=g, device=dev, dtype=f64) * 0.05)
        T.diagonal().copy_(d)
        A[l] = q @ T @ q.T
    return A


def krylov_mf_ops(dev):
    """The p=12 N=10000 diagonal-plus-superdiagonal operators of
    tests/test_krylov.py::test_krylov_large_matrix_free (drawn there from
    the ``rng`` fixture, numpy default_rng(1234)), as torch callables on
    the card."""
    import torch
    rng = np.random.default_rng(1234)
    p, n = KRYLOV_MF_P, KRYLOV_MF_N
    diags = [0.5 + rng.random(n) for _ in range(p)]
    offs = [0.1 * rng.standard_normal(n - 1) for _ in range(p)]
    for d in diags:
        d[:6] += np.linspace(3.0, 1.5, 6)

    def mk(d, o):
        def op(x):
            y = d * x
            y[:-1] += o * x[1:]
            return y
        return op

    return [mk(torch.tensor(diags[l], device=dev), torch.tensor(offs[l], device=dev))
            for l in range(p)]


def krylov_contract(apply, ps):
    """tests/test_krylov.py::check_partial's contract, computed on the card:
    per-column residuals of the Schur slot below max(|lambda_i|, ||T||
    eps), the interior couplings below max(max|lambda|, 1), each V[l]
    orthonormal within 100 k eps.  ``apply(l, X)`` is A[l] @ X.  Returns
    (ok, the largest residual entry of the Schur slot (the Ritz residual)
    and of the interior slots, the orthonormality, the worst column
    residual over its threshold)."""
    import torch
    V, T, vals = ps.Vs, ps.Ts, ps.values
    p, _, k = V.shape
    eps = float(torch.finfo(torch.float64).eps)
    if k == 0:
        return False, float("nan"), float("nan"), float("nan"), float("nan")
    R = apply(p - 1, V[p - 1]) - V[0] @ T[p - 1]
    thresh = torch.clamp(vals.abs(), min=float(torch.linalg.norm(T[p - 1])) * eps)
    col = float((torch.linalg.vector_norm(R, dim=0) / thresh).max())
    schur, inner = float(R.abs().max()), 0.0
    inner_ok = True
    for l in range(p - 1):
        Rl = apply(l, V[l]) - V[l + 1] @ T[l]
        inner = max(inner, float(Rl.abs().max()))
        inner_ok &= float(torch.linalg.vector_norm(Rl, dim=0).max()) < max(
            float(vals.abs().max()), 1.0)
    eye = torch.eye(k, dtype=V.dtype, device=V.device)
    orth = max(float((V[l].mH @ V[l] - eye).abs().max()) for l in range(p))
    return (col < 1.0 and inner_ok and orth < 100 * k * eps), schur, inner, orth, col


def krylov_leg(dev, label, run, apply, nev, lam_ref=None, coupling_max=None, min_conv=None):
    """One ``partial_pschur`` leg on the card: wall (host clock to a
    synchronise), nprods, nconverged, the timings phases and the host reads
    per operator application; then the same call under the profiler.
    Checks: every output tensor on ``dev``, ``krylov_contract``, the
    Ritz values within 1e-6 relative of ``lam_ref`` (the construction's
    top values) and nconverged >= nev, or, without ``lam_ref``, every
    residual entry of every slot below ``coupling_max`` and nconverged >=
    min_conv."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, h = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev = torch.device(dev)
    on_card = all(t.device == dev for t in (ps.Ts, ps.Vs, ps.values, ps.residuals))
    ok, schur, inner, orth, col = krylov_contract(apply, ps)
    line = (f"krylov {label}: wall {wall:.3f} s, nprods {h.nprods}, nconverged "
            f"{h.nconverged}, host reads {h.host_reads} ({h.host_reads / max(h.nprods, 1):.2f} "
            f"per operator application), timings {h.timings}; contract ok={ok} (column "
            f"residual / threshold {col:.3e}, largest residual entry: Schur slot "
            f"{schur:.3e}, interior slots {inner:.3e}, against max|T| "
            f"{float(ps.Ts.abs().max()):.3e}; orth {orth:.3e}), on {dev} {on_card}")
    if lam_ref is not None:
        top = np.sort(np.abs(ps.values.cpu().numpy()))[-nev:]
        err = float(np.abs(top - lam_ref).max() / lam_ref.max()) if len(top) == nev else np.inf
        line += f", Ritz values vs the construction {err:.3e} relative"
        good = err <= 1e-6 and h.nconverged >= nev
    else:
        good = max(schur, inner) < coupling_max and h.nconverged >= min_conv
    _log(line)
    if not (on_card and ok and good):
        raise AssertionError(f"krylov {label} failed its checks")
    leg_profile(f"krylov {label}", run)


def krylov_phase(dev):
    """``partial_pschur`` on the card through the public entry point (no
    kernel of its own: each operator application and its Gram-Schmidt are
    torch products on the card, the restart logic runs on the host):

    (a) the JAX package's on-chip Krylov cell: the draw of
        benchmarks/probe_krylov_chip.py at p=4 n=256 (seed 11), nev=4, LM,
        the probe's defaults;
    (b) the same construction at p=4 n=4096 (0.54 GB of factors), made on
        the card, with ``tol=0``: the default tol compares a slot's
        residual with tol |lambda| of the product, which is 1.02^(3n)
        larger than the factors here, so every Ritz value locks after the
        first restart at whatever accuracy that Krylov space reached (on
        the CPU at n=4096, ``scripts/krylov_tol_check.py``: beyond 1e-6 for
        6 of 12 start vectors); tol=0 leaves the eps^(2/3) ||T|| floor;
    (c) BASELINE config 5's scale: the p=12 N=10000 matrix-free operators
        of tests/test_krylov.py as torch callables on the card, nev=5,
        mindim 12, maxdim 26, seed 11; coupling residuals below 1e-5 and
        nconverged >= 2, as that test asks."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    p, nev = KRYLOV_P, KRYLOV_NEV
    for n, tol, make in ((KRYLOV_N, None,
                          lambda n: torch.tensor(krylov_draw(p, n, KRYLOV_SEED), device=dev)),
                         (KRYLOV_N_LARGE, 0.0,
                          lambda n: krylov_draw_card(dev, p, n, KRYLOV_SEED))):
        A = make(n)
        lam_top = np.sort((1.02 ** np.arange(n)) ** p)[-nev:]
        kw = {} if tol is None else {"tol": tol}
        krylov_leg(dev, f"p={p} n={n} nev={nev} LM{'' if tol is None else f' tol={tol}'}",
                   lambda: pt.partial_pschur(A, nev, "LM", **kw),
                   lambda l, X: A[l] @ X, nev, lam_ref=lam_top)
        del A
    ops = krylov_mf_ops(dev)

    def apply_mf(l, X):
        return torch.stack([ops[l](X[:, j]) for j in range(X.shape[1])], dim=1)

    krylov_leg(dev, f"matrix-free p={KRYLOV_MF_P} N={KRYLOV_MF_N} nev={KRYLOV_MF_NEV}",
               lambda: pt.partial_pschur(ops, KRYLOV_MF_NEV, "LM", n=KRYLOV_MF_N,
                                         dtype=torch.float64, device=dev, mindim=12,
                                         maxdim=26, seed=KRYLOV_MF_SEED),
               apply_mf, KRYLOV_MF_NEV, coupling_max=1e-5, min_conv=2)


# ---------------------------------------------------------------------------
# several problems at once, shards over devices, the ring (parallel/)

ENS_P, ENS_N, ENS_COUNT, ENS_SEED = 8, 128, 8, 99  # bench.py:99-115
BATCH_P, BATCH_N, BATCH_COUNT, BATCH_SEED = 4, 64, 4, 4064
SHARD_P, SHARD_N, SHARD_SEED = 4, 127, 127


def launch_counters():
    """Every wrapper's launch counts (one dict per module)."""
    from periodicschurdecompositions_jl_torch.ops import (deflate, glue, hessenberg,
                                                         pqz_deflate, rgopen, sweep, sweep_cx,
                                                         sweep_rg)
    return [sweep.launches, deflate.launches, hessenberg.launches, glue.launches,
            sweep_cx.launches, sweep_rg.launches, rgopen.launches, pqz_deflate.launches]


def zero_counts():
    for d in launch_counters():
        for k in d:
            d[k] = 0


def read_counts():
    return {k: v for d in launch_counters() for k, v in d.items()}


def ensemble_draw():
    """bench.py:99-115: default_rng(99), one warm-up cycle scaled by 0.5,
    then 8 cycles (p=8, n=128)."""
    rng = np.random.default_rng(ENS_SEED)
    warm = rng.standard_normal((ENS_P, ENS_N, ENS_N)) * 0.5
    return warm, [rng.standard_normal((ENS_P, ENS_N, ENS_N)) for _ in range(ENS_COUNT)]


def ensemble_phase(dev):
    """``ensemble_pschur_real_pipelined`` on bench.py's throughput draw:
    sequentially (``workers=1``, the caller's stream) and with two workers
    (threads, each on its own stream); walls, problems/min and, under the
    profiler, the device idle share of both.  Each pipelined (T, Z, wr, wi)
    must equal the sequential one bit for bit, converge, and have a backward
    error <= 1e-12.  Returns the launch counts of the two-worker run."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    warm, As = ensemble_draw()
    pt.ensemble_pschur_real_pipelined([warm], device=dev, workers=1)  # bench.py's warm-up
    coop_pair_check(dev, As)
    out, walls, launches = {}, {}, {}
    for workers in (1, 2):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[workers] = pt.ensemble_pschur_real_pipelined(As, device=dev, workers=workers)
        torch.cuda.synchronize()
        walls[workers] = time.perf_counter() - t0
        launches[workers] = read_counts()
    worst, same = 0.0, True
    for b, (s, q) in enumerate(zip(out[1], out[2])):
        if not (s[4] and q[4]):
            raise AssertionError(f"ensemble problem {b} did not converge")
        worst = max(worst, backerr(As[b], q[0], q[1]))
        for name, x, y in zip(("T", "Z", "wr", "wi"), s[:4], q[:4]):
            if not np.array_equal(x, y):
                same = False
                _log(f"ensemble problem {b}: pipelined {name} differs from the sequential one "
                     f"by {np.abs(x - y).max():.3e}")
    rate = {w: ENS_COUNT / walls[w] * 60 for w in walls}
    _log(f"ensemble {ENS_COUNT} x (p={ENS_P}, n={ENS_N}) seed {ENS_SEED}: sequential "
         f"{walls[1]:.3f} s ({rate[1]:.1f} problems/min), two workers {walls[2]:.3f} s "
         f"({rate[2]:.1f} problems/min, x{walls[1] / walls[2]:.3f}); bit for bit: {same}; "
         f"backward error <= {worst:.3e}; launches (two workers) "
         f"{ {k: v for k, v in launches[2].items() if v} }")
    if not same:
        raise AssertionError("the pipelined ensemble differs from the sequential one")
    if not worst <= 1e-12:
        raise AssertionError(f"ensemble backward error {worst:.3e}")
    for workers in (1, 2):
        leg_profile(f"ensemble workers={workers}", lambda: pt.ensemble_pschur_real_pipelined(
            As, device=dev, workers=workers))
    return launches[2]


def coop_cases(dev, As):
    """The three cooperative kernels at the ensemble's size (p=8, n=128), each
    as (label, kernel name, make, launch): ``make()`` gives fresh inputs,
    ``launch(x, stream)`` enqueues the C entry on that stream and returns its
    outputs (no host read, no wrapper)."""
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda
    lib = _cuda.load()
    p, n = As[0].shape[0], As[0].shape[-1]

    def hess_make(k):
        return lambda: (torch.tensor(As[k], device=dev),
                        torch.eye(n, dtype=torch.float64, device=dev).expand(p, n, n).clone(),
                        torch.empty(n + 2, dtype=torch.float64, device=dev))

    def hess_launch(x, st):
        nl = ctypes.c_int(0)
        _cuda.check(lib.psd_hess_reduce(x[0].data_ptr(), x[1].data_ptr(), x[2].data_ptr(),
                                        p, n, ctypes.byref(nl), st), "hess_reduce")
        return x[:2]

    _, Hd, Zd, i = deflate_cases(p, n)[1]   # chainB
    sc = deflate_scalars(Hd, i)

    def d_launch(x, st):
        _cuda.check(lib.psd_deflate2x2(
            x[0].data_ptr(), x[1].data_ptr(), p, n + 1, i, int(sc["jmin"]), int(sc["jmax"]),
            int(bool(sc["replace0"])), int(bool(sc["finzero"])), float(sc["cs0"]),
            float(sc["sn0"]), float(sc["thr"]), st), "deflate2x2")
        return x

    Hr, Zr, rotn = mk_rg_problem(p, n, np.random.default_rng(2026))
    rot = torch.tensor(rotn, device=dev)
    Sd = torch.tensor([int(x) for x in alternating(p)], dtype=torch.int32, device=dev)

    def r_launch(x, st):
        _cuda.check(lib.psd_rg_ladder(x[0].data_ptr(), x[1].data_ptr(), rot.data_ptr(),
                                      Sd.data_ptr(), p, n, 0, 0, n - 1, n, 0, st), "rg_ladder")
        return x

    return [("reduction", "hess_reduce_kernel", [hess_make(0), hess_make(1)], hess_launch),
            ("D", "deflate2x2_kernel",
             [lambda: (torch.tensor(Hd, device=dev), torch.tensor(Zd, device=dev))] * 2,
             d_launch),
            ("R (open)", "rg_ladder_kernel",
             [lambda: (torch.tensor(Hr, device=dev), torch.tensor(Zr, device=dev))] * 2,
             r_launch)]


def coop_pair_check(dev, As):
    """Each cooperative kernel (the reduction, D, R) launched on two streams
    at once, as two ensemble workers may launch them: both streams wait
    behind a ~1 ms sleep on the caller's stream, so the two launches are
    queued before either may start, and the card decides whether they run
    side by side.  No hang, no refused launch, each result bit for bit the
    launch's alone.  What the card did is read from the kernels' own start
    and end in a profiler trace (overlap: the later start before the earlier
    end); CUDA events give the pair's device span beside one launch's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cur = torch.cuda.current_stream(dev)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for label, kname, makes, launch in coop_cases(dev, As):
        ref = []
        for mk in makes:
            ref.append(launch(mk(), cur.cuda_stream))
        one = []
        for _ in range(3):
            x = makes[0]()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record(cur)
            launch(x, cur.cuda_stream)
            e1.record(cur)
            torch.cuda.synchronize()
            one.append(e0.elapsed_time(e1))

        def pair():
            xs = [mk() for mk in makes]
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(cur)
            ends, outs = [], []
            for st, x in zip(streams, xs):
                st.wait_stream(cur)
                outs.append(launch(x, st.cuda_stream))
                e = torch.cuda.Event(enable_timing=True)
                e.record(st)
                ends.append(e)
            torch.cuda.synchronize()
            return outs, sorted(e0.elapsed_time(e) for e in ends)

        outs, ends = pair()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs2, ends2 = pair()
        iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                    if kname in e.name and "CUDA" in str(e.device_type))
        if len(iv) == 2:
            verdict = ("side by side" if iv[1][0] < iv[0][1] else "one after the other")
            seen = (f"trace: starts {0.0:.1f} / {iv[1][0] - iv[0][0]:.1f} us, ends "
                    f"{iv[0][1] - iv[0][0]:.1f} / {iv[1][1] - iv[0][0]:.1f} us: {verdict}")
        else:
            seen = f"trace: {len(iv)} of the two launches recorded, no verdict"
        same = all(torch.equal(a, b) for o in (outs, outs2)
                   for ox, rx in zip(o, ref) for a, b in zip(ox, rx))
        _log(f"two cooperative launches of {label} (p={As[0].shape[0]}, n={As[0].shape[-1]}) "
             f"on two streams, queued together: {seen}; device span of the pair after the "
             f"release (events) {ends[1]:.4f} ms (ends {ends[0]:.4f} / {ends[1]:.4f}; profiled "
             f"run {ends2[0]:.4f} / {ends2[1]:.4f}), one launch alone {min(one):.4f} ms: the "
             f"later end {(ends[1] - ends[0]) / min(one):.2f} launches after the earlier; bit "
             f"for bit the launches alone: {same}")
        if not same:
            raise AssertionError(f"cooperative launches of {label} on two streams changed "
                                 f"their results")


def batched_phase(dev):
    """``batched_pschur_complex`` on 4 x (p=4, n=64) with an alternating
    signature on the card (two workers on their own streams) against the
    same call with one worker, bit for bit; every lane converged with a
    backward error <= 1e-12."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    rng = np.random.default_rng(BATCH_SEED)
    shape = (BATCH_COUNT, BATCH_P, BATCH_N, BATCH_N)
    A = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    S = alternating(BATCH_P)
    At = torch.tensor(A, device=dev)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pt.batched_pschur_complex(At, S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    ref = pt.batched_pschur_complex(At, S, workers=1)
    same = all(torch.equal(x, y) for x, y in zip(out, ref))
    T, Z, ok = out[0].cpu().numpy(), out[1].cpu().numpy(), out[5].cpu().numpy()
    be = max(cx_backerr(A[b], T[b], Z[b], S) for b in range(BATCH_COUNT))
    _log(f"batched_pschur_complex {BATCH_COUNT} x (p={BATCH_P}, n={BATCH_N}) alternating S: "
         f"wall {wall:.3f} s, converged {ok.tolist()}, backward error <= {be:.3e}, bit for "
         f"bit with one worker: {same}; launches { {k: v for k, v in launches.items() if v} }")
    if not (ok.all() and same and be <= 1e-12 and out[0].device == At.device):
        raise AssertionError("batched_pschur_complex failed its checks")


def shard_cuts(N, D):
    """D contiguous shards of N lines, as even as N allows: (offset, L)."""
    b = [round(k * N / D) for k in range(D + 1)]
    return [(b[k], b[k + 1] - b[k]) for k in range(D)]


def shard_apply(H0, Z0, R, m, i, D, plain=False):
    """B0 on D column shards of a copy of H0, then B on D row shards of it
    and of a copy of Z0 (each shard a contiguous copy on the card, put back
    after its launch): the shard entries, or ``apply_log_shard_plain``."""
    from periodicschurdecompositions_jl_torch.ops import sweep
    H, Z = H0.clone(), Z0.clone()
    N = H.shape[-1]
    for c0, L in shard_cuts(N, D):
        Hc = H[:, :, c0:c0 + L].contiguous()
        if plain:
            sweep.apply_log_shard_plain(Hc, None, R, m, i, side="left", offset=c0)
        else:
            sweep.sweep_left_shard(Hc, R, m, i, c0)
        H[:, :, c0:c0 + L] = Hc
    for r0, L in shard_cuts(N, D):
        Hr, Zr = H[:, r0:r0 + L].contiguous(), Z[:, r0:r0 + L].contiguous()
        if plain:
            sweep.apply_log_shard_plain(Hr, Zr, R, m, i, side="right", offset=r0, want_z=True)
        else:
            sweep.sweep_right_shard(Hr, Zr, R, m, i, r0, want_z=True)
        H[:, r0:r0 + L], Z[:, r0:r0 + L] = Hr, Zr
    return H, Z


def shard_phase(dev, report):
    """The shard entries (``psd_sweep_left_shard``, ``psd_sweep_right_shard``)
    at p=16 n=512 and p=8 n=256 on kernel A's log of two windows: with D =
    1, 2, 4 shards (N = n + 1 cut as evenly as it goes) bit for bit the
    unsharded B0 and B on the same input and log; against
    ``apply_log_shard_plain`` on the same shards with the gate max(1e-12, 10
    x the plain version's own change under a relative 1e-16 perturbation of
    H); times of D = 1 against B0 / B (CUDA events, in turns, each through
    its C entry: offset 0, the full width)."""
    import torch
    from periodicschurdecompositions_jl_torch.ops import _cuda, sweep
    lib = _cuda.load()
    st = torch.cuda.current_stream().cuda_stream
    err, times = 0.0, {}
    for (p, n) in ((P_HEAD, N_HEAD), (8, 256)):
        N = n + 1
        Hn, Zn, v0 = mk_sweep_problem(p, n, np.random.default_rng(2424 + p))
        for (m, i) in ((0, n - 1), (37, min(300, n - 2))):
            H0 = torch.tensor(Hn, device=dev)
            if m > 0:
                H0[0, m, m - 1] = 0.0
            H0[0, i + 1, i] = 0.0
            Z0 = torch.tensor(Zn, device=dev)
            R = sweep.sweep_generate(H0, m, i, v0)
            Hu, Zu = H0.clone(), Z0.clone()
            _cuda.check(lib.psd_sweep_left(Hu.data_ptr(), R.data_ptr(), p, N, m, i, 1, st),
                        "sweep_left")
            _cuda.check(lib.psd_sweep_right(Hu.data_ptr(), Zu.data_ptr(), R.data_ptr(), p, N,
                                            m, i, 1, st), "sweep_right")
            pert = torch.tensor(1.0 + 1e-16 * np.random.default_rng(1).standard_normal(
                Hn.shape), device=dev)
            Hq, Zq = shard_apply(H0 * pert, Z0, R, m, i, 1, plain=True)
            scale = float(H0.abs().max())
            for D in (1, 2, 4):
                Hs, Zs = shard_apply(H0, Z0, R, m, i, D)
                Hp, Zp = shard_apply(H0, Z0, R, m, i, D, plain=True)
                sens_h = float((Hq - Hp).abs().max()) / scale
                sens_z = float((Zq - Zp).abs().max())
                dh = float((Hs - Hp).abs().max()) / scale
                dz = float((Zs - Zp).abs().max())
                bitwise = torch.equal(Hs, Hu) and torch.equal(Zs, Zu)
                tol_h, tol_z = max(TOL, 10 * sens_h), max(TOL, 10 * sens_z)
                _log(f"shards p={p} n={n} [{m}, {i}] D={D} {shard_cuts(N, D)}: bit for bit "
                     f"B0/B: {bitwise}; vs apply_log_shard_plain {dh:.3e} / {dz:.3e} "
                     f"(tolerance {tol_h:.3e} / {tol_z:.3e})")
                if not bitwise:
                    raise AssertionError(f"shard entries differ from B0/B at p={p} n={n} "
                                         f"[{m}, {i}] D={D}")
                if not (dh <= tol_h and dz <= tol_z):
                    raise AssertionError("shard entries disagree with apply_log_shard_plain")
                err = max(err, dh, dz)
        # times on [0, n-1], D = 1, in turns with the unsharded launches
        m, i = 0, n - 1
        H = torch.tensor(Hn, device=dev)
        Z = torch.tensor(Zn, device=dev)
        R = sweep.sweep_generate(H, m, i, v0)
        t = {"B0": [], "B0 shard": [], "B": [], "B shard": []}
        for _ in range(3):
            t["B0"].append(event_ms(lambda: _cuda.check(lib.psd_sweep_left(
                H.data_ptr(), R.data_ptr(), p, N, m, i, 1, st), "sweep_left"), 20))
            t["B0 shard"].append(event_ms(lambda: _cuda.check(lib.psd_sweep_left_shard(
                H.data_ptr(), R.data_ptr(), p, N, m, i, 1, N, N, 0, N, st),
                "sweep_left_shard"), 20))
            t["B"].append(event_ms(lambda: _cuda.check(lib.psd_sweep_right(
                H.data_ptr(), Z.data_ptr(), R.data_ptr(), p, N, m, i, 1, st),
                "sweep_right"), 20))
            t["B shard"].append(event_ms(lambda: _cuda.check(lib.psd_sweep_right_shard(
                H.data_ptr(), Z.data_ptr(), R.data_ptr(), p, N, m, i, 1, 0, 0, N, st),
                "sweep_right_shard"), 20))
        Hp, Zp = H.clone(), Z.clone()
        t_plain = wall_ms(lambda: shard_apply(Hp, Zp, R, m, i, 1, plain=True))
        _log(f"shard entries at p={p} n={n} [0, {n - 1}], D = 1 (turns): "
             + ", ".join(f"{k} {' / '.join(f'{x:.4f}' for x in v)} ms" for k, v in t.items())
             + f"; plain (B0+B shards) {t_plain:.1f} ms")
        if (p, n) == (P_HEAD, N_HEAD):
            times = {k: min(v) for k, v in t.items()}
            times["plain"] = t_plain
    bounds = apply_bounds(P_HEAD, N_HEAD, 0, N_HEAD - 1)
    src = "periodicschurdecompositions_jl_torch/csrc/sweep.cu"
    rep = "periodicschurdecompositions_jl_tpu/parallel/sweep_sharded.py:56"
    for name, key, b in (("sweep_left_shard", "B0 shard", "sweep_left"),
                         ("sweep_right_shard", "B shard", "sweep_right")):
        report[name] = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                        "max_abs_err": err, "ms": times[key], "plain_ms": times["plain"],
                        "bound_ms": bounds[b][0], "bound_by": bounds[b][1],
                        "library_ms": None}


def sharded_pschur_phase(dev):
    """``pschur_real_sharded`` with two shards on one card (explicit copies:
    the two-card path) on a p=4 n=127 draw (N = 128): backward error <=
    1e-12, and T, Z and the eigenvalues bit for bit those of the one-card
    ``pschur_real_pipeline`` without AED and the host tail (the shard
    entries are B0/B bit for bit).  Returns the launch counts of the
    sharded run."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    A = np.random.default_rng(SHARD_SEED).standard_normal((SHARD_P, SHARD_N, SHARD_N))
    At = torch.tensor(A, device=dev)
    P = pqr_real.pschur_real_pipeline(At, "R", cfg=AlgoConfig(aed=False, host_tail=-1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P = pqr_real.pschur_real_pipeline(At, "R", cfg=AlgoConfig(aed=False, host_tail=-1))
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    niter = pqr_real.last_info["niter"]
    zero_counts()
    t0 = time.perf_counter()
    T, Z, w, ok = pt.pschur_real_sharded(At, (dev, dev))
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches = read_counts()
    be = backerr(A, T.cpu().numpy(), Z.cpu().numpy())
    same = (torch.equal(T, P.Ts) and torch.equal(Z, P.Zs)
            and np.array_equal(w, P.values.cpu().numpy()))
    _log(f"pschur_real_sharded p={SHARD_P} n={SHARD_N} seed {SHARD_SEED}, two shards on "
         f"{dev}: wall {wall2:.3f} s (one card, AED off: {wall1:.3f} s, niter {niter}), "
         f"converged {ok}, backward error {be:.3e}, T, Z and eigenvalues bit for bit the "
         f"one-card run's: {same}; launches { {k: v for k, v in launches.items() if v} }")
    if not (ok and same and be <= 1e-12):
        raise AssertionError("pschur_real_sharded failed its checks")
    if launches["sweep_left"] or launches["sweep_right"]:
        raise AssertionError("the sharded core launched the unsharded B0/B")
    return launches


def ring_krylov_phase(dev):
    """Two shards on one card: ``ring_cycle_products`` and
    ``ring_product_apply`` (p=8, n=512) against the product on one card
    (1e-12 relative), and ``partial_pschur(ShardedCycleOps(A, (dev, dev)),
    4, "LM")`` on the Krylov cell against the one-card ``CycleOps`` run:
    Ritz values within 1e-10 relative, nconverged equal, two host reads an
    operator application."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    mesh = (dev, dev)
    rng = np.random.default_rng(2425)
    p, n, b = 8, 512, 4
    A = torch.tensor(rng.standard_normal((p, n, n)) / np.sqrt(n), device=dev)
    V = torch.tensor(rng.standard_normal((2, n, b)), device=dev)
    v = torch.tensor(rng.standard_normal(n), device=dev)
    t0 = time.perf_counter()
    out = pt.ring_cycle_products(A, V, mesh)
    y = pt.ring_product_apply(A, v, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    K = p // 2
    ref = []
    for d in range(2):
        x = V[d]
        for k in [(d * K + j) % p for j in range(p)]:
            x = A[k] @ x
        ref.append(x)
    ref = torch.stack(ref)
    x = v
    for k in range(p):
        x = A[k] @ x
    e1 = float((out - ref).abs().max() / ref.abs().max())
    e2 = float((y - x).abs().max() / x.abs().max())
    Ak = torch.tensor(krylov_draw(KRYLOV_P, KRYLOV_N, KRYLOV_SEED), device=dev)
    ps1, h1 = pt.partial_pschur(Ak, KRYLOV_NEV, "LM")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps2, h2 = pt.partial_pschur(pt.ShardedCycleOps(Ak, mesh), KRYLOV_NEV, "LM")
    torch.cuda.synchronize()
    wall_k = time.perf_counter() - t0
    a = np.sort_complex(ps2.values.cpu().numpy())
    r = np.sort_complex(ps1.values.cpu().numpy())
    ek = float(np.abs(a - r).max() / np.abs(r).max()) if a.shape == r.shape else np.inf
    _log(f"ring on two shards of {dev}: cycle products vs one card {e1:.3e}, product apply "
         f"{e2:.3e} (relative; {wall * 1e3:.1f} ms); ShardedCycleOps Krylov cell: wall "
         f"{wall_k:.3f} s, nprods {h2.nprods} (one card {h1.nprods}), nconverged "
         f"{h2.nconverged} / {h1.nconverged}, host reads {h2.host_reads}, Ritz values vs one "
         f"card {ek:.3e} relative")
    if not (e1 <= 1e-12 and e2 <= 1e-12 and out.device == A.device):
        raise AssertionError("the ring disagrees with the one-card product")
    if not (ek <= 1e-10 and h2.nconverged == h1.nconverged
            and h2.host_reads == 2 * h2.nprods and ps2.Vs.device == Ak.device):
        raise AssertionError("ShardedCycleOps disagrees with the one-card CycleOps")


def hostile_exp_split(p, n, fac, seed):
    """benchmarks/probe_rg_hostile.py's exponentially split spectrum: factor
    diagonals graded fac^1..fac^3, mixed signature."""
    r = np.random.default_rng(seed)
    A = np.zeros((p, n, n))
    for l in range(p):
        d = fac ** (1 + 2 * r.random(n))
        Tl = np.triu(r.standard_normal((n, n)), 1) * d.max() * 0.1
        np.fill_diagonal(Tl, d)
        q1, _ = np.linalg.qr(r.standard_normal((n, n)))
        q2, _ = np.linalg.qr(r.standard_normal((n, n)))
        A[l] = q1 @ Tl @ q2.T
    return A, tuple((l % 2 == 0) or (l == 0) for l in range(p))


def hostile_near_singular(p, n, floor, seed):
    """The probe's near-singular inverted factors: their diagonals graded
    down to ``floor``."""
    r = np.random.default_rng(seed)
    A = r.standard_normal((p, n, n))
    S = tuple(l % 2 == 0 for l in range(p))
    for l in range(p):
        if not S[l]:
            Tl = np.triu(r.standard_normal((n, n)))
            np.fill_diagonal(Tl, np.logspace(0, np.log10(floor), n)
                             * np.sign(r.standard_normal(n)))
            q1, _ = np.linalg.qr(r.standard_normal((n, n)))
            q2, _ = np.linalg.qr(r.standard_normal((n, n)))
            A[l] = q1 @ Tl @ q2.T
    return A, S


def hostile_graded(p, n, seed):
    """The probe's graded bands: plain Gaussian draws, alternating S."""
    r = np.random.default_rng(seed)
    return r.standard_normal((p, n, n)), tuple(l % 2 == 0 for l in range(p))


def hostile_rg_cases(quick=False):
    """The 33 draws of benchmarks/probe_rg_hostile.py (``quick``: its 14):
    exp-split spectra at p=20 n=8 and p=12 n=16, near-singular inverted
    factors at p=6 n=24, graded bands at n=128/192/256; (tag, A, S)."""
    cases = []
    for seed in range(5 if quick else 10):
        cases.append((f"exp-split p=20 n=8 fac=2 seed={seed}",)
                     + hostile_exp_split(20, 8, 2.0, seed))
    for seed in range(3 if quick else 6):
        cases.append((f"exp-split p=12 n=16 fac=3 seed={seed}",)
                     + hostile_exp_split(12, 16, 3.0, seed))
    for floor in (1e-6, 1e-10):
        for seed in range(2 if quick else 4):
            cases.append((f"near-sing-inv p=6 n=24 floor={floor:g} seed={seed}",)
                         + hostile_near_singular(6, 24, floor, seed))
    for (p, n) in ([(8, 128)] if quick else [(8, 128), (12, 192), (16, 256)]):
        for seed in range(2 if quick else 3):
            cases.append((f"graded p={p} n={n} seed={seed}",) + hostile_graded(p, n, seed))
    return cases


def hostile_rg_case(dev, A, S):
    """One hostile draw through ``pschur(A, 'R', S)`` on ``dev``, and the
    native C++ core (the probe's oracle) on the same reduction: (niter,
    the native core's rc and niter, backward error honouring S, wall)."""
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch import native
    from periodicschurdecompositions_jl_torch.ops import hessenberg, pqz_real
    At = torch.tensor(A, device=dev)
    t0 = time.perf_counter()
    P = pt.pschur(At, "R", S)
    if At.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    niter = pqz_real.last_info["niter"]
    H, _ = hessenberg.phessenberg_signed_core(At, S, want_q=False)
    rc, nn, _ = native.pqz_real_gen_niter_cpu(H.cpu().numpy(), S)
    be = cx_backerr(A, P.Ts.cpu().numpy(), P.Zs.cpu().numpy(), S)
    return niter, rc, nn, be, wall


def hostile_rg_phase(dev, quick=True):
    """The probe's hostile rg draws (``quick``: its 14) through the port on
    the card: each converges within 120 n iterations with a backward error
    <= 1e-12; niter beside the native core's, beyond 60 n flagged."""
    worst = 0.0
    for tag, A, S in hostile_rg_cases(quick):
        n = A.shape[-1]
        niter, rc, nn, be, wall = hostile_rg_case(dev, A, S)
        flag = "  <-- BEYOND 60n" if niter > 60 * n else ""
        _log(f"[rg-hostile] {tag}: niter {niter} ({niter / n:.1f}n of 120n), native core rc "
             f"{rc} niter {nn} ({nn / n:.1f}n); backward error {be:.3e}; wall {wall:.3f} s"
             f"{flag}")
        if not (niter <= 120 * n and be <= 1e-12):
            raise AssertionError(f"hostile rg draw {tag}: niter {niter}, backward error {be:.3e}")
        worst = max(worst, niter / n)
    _log(f"[rg-hostile] worst {worst:.1f}n of the 120n budget")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import periodicschurdecompositions_jl_torch  # noqa: F401  (fails outside the repo)
    from periodicschurdecompositions_jl_torch.ops import _cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]}")
    dev = torch.device("cuda:0")

    t_start = t0 = time.perf_counter()
    _cuda.load()
    _log(f"kernel build (nvcc) + load: {time.perf_counter() - t0:.2f} s")
    from periodicschurdecompositions_jl_torch import native
    t0 = time.perf_counter()
    native.load()
    _log(f"native window Schur build (g++) + load: {time.perf_counter() - t0:.2f} s")

    report = {}
    hess_phase(dev, report)
    hess_signed_phase(dev, report)
    sweep_phase(dev, P_HEAD, N_HEAD, report)
    mb_phase(dev, P_HEAD, N_HEAD, report)
    deflate_phase(dev, P_HEAD, N_HEAD, report)
    small_reference_check(dev)
    with capture_glue_states() as cap:
        launches, head = e2e_case(dev, P_HEAD, N_HEAD, SEED_HEAD, "R")
    glue_phase(dev, list(cap.states.values()), report)
    del cap
    # the default main path: AED and the host tail; its counts go in the line
    aed_launches, _ = e2e_case(dev, P_HEAD, N_HEAD, SEED_HEAD, "R",
                               ref_values=head["values"], aed=True)
    for k in ("sweep_generate", "sweep_left", "sweep_right", "deflate2x2", "glue",
              "hess_reduce"):
        launches[k] = aed_launches[k]
    reorder_phase(dev)
    mb_launches, _ = e2e_case(dev, P_HEAD, N_HEAD, SEED_HEAD, "R", nbulges=MB_NB,
                              ref_values=head["values"])
    launches["sweep_generate_mb"] = mb_launches["sweep_generate_mb"]
    _, small = e2e_case(dev, 8, 128, 99, "L")
    e2e_case(dev, 8, 128, 99, "L", nbulges=2, ref_values=small["values"])

    cx_kernel_phase(dev, P_CX, N_CX, report)
    cx_small_check(dev)
    _, cx_off_values = cx_e2e_case(dev, P_CX, N_CX, SEED_CX, None, "R", aed_off=True)
    cx_iteration_profile(dev, P_CX, N_CX, SEED_CX)
    # the default complex leg (AED and the host tail); its counts go in the line
    cx_launches, _ = cx_e2e_case(dev, P_CX, N_CX, SEED_CX, None, "R",
                                 ref_values=cx_off_values)
    launches.update(cx_launches)
    cx_signed, _ = cx_e2e_case(dev, P_CX, N_CX_SIGNED, SEED_CX, alternating(P_CX), "R")
    launches["hess_signed_c128"] = cx_signed["hess_signed_c128"] + cx_launches["hess_signed_c128"]
    launches["deflate_czshift_c128"] += cx_signed["deflate_czshift_c128"]

    rg_kernel_phase(dev, P_RG, N_RG, report)
    rg_small_check(dev)
    rg_off, rg_hq, rg_off_values = rg_e2e_case(dev, P_RG, N_RG, SEED_RG, aed_off=True)
    rg_czshift_check(dev, alternating(P_RG), rg_hq)
    # the default rg leg (AED and the host tail); its counts go in the line,
    # CZSHIFT's from the AED-off leg when the default leg took none
    rg_launches, _, _ = rg_e2e_case(dev, P_RG, N_RG, SEED_RG, ref_values=rg_off_values)
    if rg_launches["deflate_czshift"] == 0:
        rg_launches["deflate_czshift"] = rg_off["deflate_czshift"]
    launches.update(rg_launches)
    rg_iteration_profile(dev, alternating(P_RG), rg_hq)
    want_t_legs(dev)
    deflate_actions_phase(dev, report, rg_hq)
    dl = deflate_leg(dev)
    for k in ("deflate_pos", "deflate_neg", "deflate_pos_c128", "deflate_neg_c128"):
        launches[k] = dl[k]
    krylov_phase(dev)
    # several problems, shards and the ring (parallel/); no run crosses two
    # cards here: every shard lies on this card, by explicit copies
    hostile_rg_phase(dev, quick=True)
    ensemble_phase(dev)
    batched_phase(dev)
    shard_phase(dev, report)
    shard_launches = sharded_pschur_phase(dev)
    for k in ("sweep_left_shard", "sweep_right_shard"):
        launches[k] = shard_launches[k]
    ring_krylov_phase(dev)

    kernels = []
    for name in ("sweep_generate", "sweep_generate_mb", "sweep_left", "sweep_right",
                 "deflate2x2",
                 "qz_sweep_generate", "qz_sweep_left", "qz_sweep_right", "qz_shift",
                 "rg_sweep_generate", "rg_sweep_left", "rg_sweep_right", "rg_ladder",
                 "hess_reduce", "hess_reduce_c128", "hess_signed", "hess_signed_c128",
                 "glue", "deflate_czshift", "deflate_pos", "deflate_neg",
                 "deflate_czshift_c128", "deflate_pos_c128", "deflate_neg_c128",
                 "sweep_left_shard", "sweep_right_shard"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} launched no time on its path")
        kernels.append({**report[name], "launches": launches[name]})
    _log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the kernel build to here")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
