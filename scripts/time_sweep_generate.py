#!/usr/bin/env python3
"""Time kernel A (csrc/sweep.cu::psd_sweep_generate) on one CUDA card, or
with ``--cx`` the complex kernel A (csrc/sweep_cx.cu::psd_qz_sweep_generate).

Draws the sweep problem of chip_smoke.py's ``sweep_phase`` (p=16, n=512,
``default_rng(2024)``) and times kernel A with CUDA events on the windows
[0, 511], [37, 300] and [200, 202] (mean of 20 launches after a warm-up).
Prints the card's name and power limit and one JSON line, with a hash of
each window's log (equal hashes: bit-identical logs).  ``--headline`` also
times one real headline ``pschur`` (p=16, n=512, seed 12345; host clock to
``torch.cuda.synchronize()``, after a small warm-up call).

``--root DIR`` imports the port from another checkout (for example the
parent commit unpacked with ``git archive``), so that two versions can be
timed in turns in one call on one card: parent, change, change, parent.
The kernel's second argument is its scratch; a (p, N, N) buffer serves
both the working copy of the design before the look-ahead window and the
window's smaller scratch.

``--cx``: the problem of chip_smoke.py's ``cx_kernel_phase`` (p=8, n=256,
``default_rng(2025)``, the window's boundary subdiagonals set to zero) and
its windows [0, 255], [37, 200] and [120, 122], each with an alternating
and an all-direct signature; the hash covers every log entry the kernel
writes.  ``--headline`` then times the complex leg of chip_smoke.py (p=8,
n=256, seed 777, no signature) and prints its iteration time and niter.
Here too the scratch is a (p, n, n) buffer, large enough for either design.

``--rg``: kernel rg A (csrc/sweep_rg.cu::psd_rg_sweep_generate) on the
problem of chip_smoke.py's ``rg_kernel_phase`` (p=8, n=256,
``default_rng(2026)``, the window's boundaries deflated, the opening ladder
applied) and its windows [1, 255], [38, 200] and [121, 124], each with an
alternating and an all-direct signature; the hash covers every log entry
the kernel writes.  ``--set NAME=VALUE`` (repeatable) also builds a copy
of sweep_rg.cu with ``constexpr int NAME`` rewritten under ``_dev/`` and
times it on the same windows (its hashes beside the source's).
``--headline`` then times the real generalized iteration of chip_smoke.py's
rg leg (p=8, n=256, seed 4242, alternating S): ``pqz_real_gen_core`` from
the leg's signed reduction, which takes most of a minute and is the same
in every version, so it is computed once and kept in the file ``--hq``
(default ``_dev/rg_hq.pt``) for the next turns; prints the iteration's
wall (the median of three runs after a warm-up, and each run), niter,
sweeps, rg A launches per run and hashes of T and Z.  ``--trace``
(with ``--headline``) then runs the iteration once more under a CPU and
CUDA ``torch.profiler`` and once under ``cProfile`` and prints where the
host time goes: the torch operations by self CPU time (the reads to the
host, the copies to the card, the launches) and the Python functions by
their own time (the numpy tests and shifts), with the full tables in the
file ``--trace-out`` (default ``_dev/rg_trace.txt``).

``--hess``: the periodic Hessenberg reduction (csrc/hess.cu through
``phessenberg_core``), float64 on the headline draw (p=16, n=512, seed
12345) and complex128 on the complex leg's draw (p=8, n=256, seed 777),
mean of ``--reps`` calls after a warm-up, with CUDA events; hashes of H and
Q on those draws and at p=1 n=64 (seed 64) and p=3 n=101 (seed 101), real
and complex (the draws of chip_smoke.py's ``hess_phase``).  Where the
source has the cooperative design's ``kStagePhases``, the script also
builds copies of hess.cu under ``_dev/`` that run the barriers only, then
the generations and barriers, then everything, and times them on the same
draws: the split of the reduction's time into barrier, generation and
update (it prints ptxas's register and spill report of those builds).
``--set NAME=VALUE`` (repeatable) rewrites ``constexpr int NAME`` in those
copies, to time a variant of the design (for example ``--set
kRowsPerWarp=2``) beside the source's own build.  ``--headline`` then
times the real headline ``pschur`` and the complex leg (walls, reduction
and iteration times, niter).  A parent whose complex reduction is the
plain torch version times that version instead.

``--signed``: the signed reduction (``phessenberg_signed_core``; stage 2
is csrc/hess_signed.cu where the checkout has it, the plain torch version
with one host read per rotation where it does not) on the rg leg's draw
(real p=8, n=256, seed 4242) and the signed complex leg's (complex p=8,
n=128, seed 777), both with an alternating S: the host clock over one call
to ``torch.cuda.synchronize()`` (the kernel: the median of ``--reps`` calls,
at most 5, and, with CUDA events, of stage 2 alone on copies of stage 1's
output), hashes of H and Q, and, for the kernel, max|dH|/max|A| and
max|dQ| against the plain version's output, which a turn of the plain
version keeps in ``_dev/signed_plain_{rg,cx}.pt`` (else the plain version
runs once).  ``--headline`` runs each draw through ``pschur(A, 'R', S)``
instead and times the reduction inside it: the leg's wall, iteration time,
niter and a hash of the eigenvalues.  ``--split`` also builds copies of
hess_signed.cu under ``_dev/`` (the source; the generations replaced by the
identity rotation; the batched update chains cut off) and times stage 2
through each, with and without Q: an attribution of the kernel's time to
its serial generations, its updates and Q.

``--deflate``: the deflation actions (``ops/pqz_deflate.py::DeflateCores``:
csrc/pqz_deflate.cu where the checkout has it, the plain torch version with
one host read per rotation where it does not) on the states of
chip_smoke.py's ``deflate_actions_phase``: the rg leg's reduction (kept in
``--hq`` as for ``--rg``) and the signed complex leg's, CZSHIFT on the
whole matrix and on an inner window, DEFLATE_POS and DEFLATE_NEG down and
up; the host clock over one call to ``torch.cuda.synchronize()`` (the
median of ``--reps`` calls, at most 5, on copies) and hashes of H and Z.
``--headline`` then times the rg iteration as ``--rg --headline`` does (and
``--trace`` attributes its host time), the rg leg's ``pschur(A, 'R', S)``,
the complex leg and the signed complex leg (walls, iteration times, niter,
CZSHIFT actions).  ``--against DIR``: instead, each action of this
checkout's kernel library against DIR's (built in a child process; the
deflation entries must have the same C signatures) in one process, in
rounds of A, B, B, A with CUDA events around each call (``--reps`` rounds),
the medians and the hashes of H and Z of both.

``--apply``: kernels B0 and B (csrc/sweep.cu::psd_sweep_left and
psd_sweep_right) on the problem of chip_smoke.py's ``sweep_phase`` (p=16,
n=512, ``default_rng(2024)``, the window's boundary subdiagonals set to
zero), on the windows [0, 511], [37, 300] and [200, 202]: NB=1 on kernel
A's log and NB=4 on A-mb's log of four bulges (gap 3, the driver's window
shifts, ``pqr_real.window_shifts``), and on [0, 511] also NB=2 and 3 (the
first bulges of that log).  For each: the sha256 of H and Z after one B0 +
B on fresh copies (equal hashes: bit-identical results) and the time of B0
and of B with CUDA events (mean of ``--reps`` launches after a warm-up, on
a copy that takes them one after the other), each beside its bound
(chip_smoke.py's ``apply_bounds``, from this checkout); on [0, 511] also three
one-log launches with bulges 0, 1 and 2's logs, and NB=3 with bulge 0's log
three times (what the NB logs cost).  Prints ptxas's register and
spill report of the apply kernels (sweep.cu of ``--root`` built alone with
``-Xptxas -v`` into _dev/).  ``--set NAME=VALUE`` (repeatable) times B0 and
B of a copy of that sweep.cu with ``constexpr int NAME`` rewritten (for
example ``--set kAhead=6``) instead.  ``--headline`` adds one real headline
``pschur`` (wall, niter, sweeps, hashes of T and Z) and the device time of
kernels A, B0 and B in a second run under the CUDA profiler.

``--cx --apply``: the complex B0 and B (csrc/sweep_cx.cu::psd_qz_sweep_left
and psd_qz_sweep_right) on the draw of chip_smoke.py's ``cx_kernel_phase``
(p=8, n=256, ``default_rng(2025)``, windows [0, 255], [37, 200], [120,
122]; and p=8, n=128 on [0, 127], the signed complex leg's shape), each
with an alternating and an all-direct signature, on kernel A's own log:
the sha256 of H after B0, of H and Z after B and of H after B without Z,
and the time of B0 and of B (CUDA events, mean of ``--reps`` launches),
each beside chip_smoke.py's ``cx_apply_bounds``, and ptxas's register
report; then kernel S (psd_qz_shift) on the same draws and windows (and
[1, n-2]), alternating, all-direct and all-inverse-but-S[0] signatures:
the sha256 of (c, s), and at p=8 n=256 on [0, 255] its time (CUDA events
and the device time under the profiler).  ``--against DIR``: DIR's library
(built in a child process) and this checkout's in turns, parent / change /
change / parent, in one process; each ``--variant NAME=V,NAME=V``
(repeatable) adds a copy of sweep_cx.cu with those constexprs rewritten
between the changes.
``--headline`` then runs the complex leg and the signed complex leg of
chip_smoke.py through the checkout's package (``--root``): wall,
iteration, niter, sweeps, hashes of T and Z, and under the CUDA profiler
the device time and launches of cx A, B0, B and S and the idle share
(run once with ``--root DIR`` for the parent's).

``--rg --apply``: rg B0 and rg B (csrc/sweep_rg.cu::psd_rg_sweep_left and
psd_rg_sweep_right) as ``--cx --apply`` does cx B0 and B, on the draw of
chip_smoke.py's ``rg_kernel_phase`` (p=8, n=256, ``default_rng(2026)``,
the window's boundaries deflated, the opening ladder applied; windows [1,
255], [38, 200], [121, 124]; and p=3, n=129 on [1, 128], its odd-n case),
alternating and all-direct S, on kernel rg A's own log, bounds from
chip_smoke.py's ``rg_apply_bounds``.  ``--headline`` then runs the rg leg
of chip_smoke.py (``pschur(A, 'R', S)``, p=8, n=256, seed 4242,
alternating S): wall, reduction, iteration, niter, sweeps, hashes of T and
Z, and under the CUDA profiler the device time and launches of rg A, B0,
B, R and CZSHIFT and the idle share (run once with ``--root DIR`` for the
parent's).

``--mb``: kernel A-mb (csrc/sweep.cu::psd_sweep_generate_mb) alone on the
problem of chip_smoke.py's ``mb_phase`` (p=16, n=512, ``default_rng(2027)``,
gap 3, the driver's window shifts ``pqr_real.window_shifts``): [0, 511]
with NB = 1..4 bulges, [0, 127] with four and [200, 263] with two of four,
the mean of ``--reps`` launches after a warm-up (CUDA events) and a hash of
each log.  ``--against DIR``: DIR's library (built in a child process) and
this checkout's in turns, parent / change / change / parent, in one
process.  The scratch is a (p, N, N) buffer, enough for either design.
``--set NAME=VALUE`` (repeatable) adds A-mb of a copy of sweep.cu with
``constexpr int NAME`` rewritten to the turns (parent, change, set, set,
change, parent).  ``--headline`` then runs the mb headline leg (``pschur_real_pipeline``,
p=16, n=512, seed 12345, nbulges=4): wall, iteration, niter, sweeps,
hashes of T and Z, the host time of the shift solve (``_mb_shifts``), and
under the CUDA profiler the device time and launches of A-mb, B0, B, G, D
and the reduction, and the idle share.

``--ladders``: kernels D (csrc/deflate.cu::psd_deflate2x2) and R
(csrc/rgopen.cu::psd_rg_ladder).  D on chip_smoke.py's ``deflate_cases``
(p=16, n=512, i=300: chainA, chainB, chainB with a negligible trailing
diagonal) and on chainB with a replacement from the first round (a loop of
several rounds); R on the draw of chip_smoke.py's ``rg_kernel_phase`` (p=8,
n=256, ``default_rng(2026)``, alternating S) at its six spots (open at 0
and 37, close at n-2 and 199, chain at 100 and n-2), each with and without
``want_t=False`` bounds.  For each case the sha256 of H and Z after one
call on fresh copies and of H after a call without Z; the time of D on its
four cases and of R open at 0, close at n-2 and chain at 100 (CUDA events,
mean of ``--reps`` calls in place after a warm-up; and the device time a
launch takes under the CUDA profiler, which leaves out the host's launch
rate through ctypes) beside its bound (chip_smoke.py's ``deflate_bound``
and ``ladder_bound``), and ptxas's register and spill report.  ``--against
DIR``: DIR's library (built in a child process) and this checkout's in
turns, parent / change / change / parent, in one process; each ``--also
NAME=DIR`` (repeatable) adds DIR's library between the changes, each
``--variant NAME=V,...`` a copy of the source with those constexprs
rewritten in both files, and ``--split`` two timing-only copies (thread 0
skips the chain; no line is loaded or stored, one block), which split a
launch's time into the chain and the rest; their results are not the
kernel's, so they are timed but left out of the hashes and of
``hashes_equal``.  ``--headline`` then runs the real headline
(wall, niter, hashes of T and Z, and under the CUDA profiler the device
time of A, B0, B, D and G), the mb headline leg and the rg leg through the
checkout's package (``--root``), each with its device time by kernel (run
once with ``--root DIR`` for the parent's).

``--glue``: kernel G (csrc/glue.cu::psd_glue) at the real headline's
states (p=16, n=512, seed 12345; chip_smoke.py's ``capture_glue_states``:
the first call, the first with its == 10, the first with its >= 16 and the
first whose lnew > 0): the sha256 of the packed buffer, the time a launch
takes with CUDA events (mean of ``--reps`` launches) and on the device
under the CUDA profiler, beside chip_smoke.py's bound, and ptxas's report;
``--against DIR``: DIR's library (built in a child process) and this
checkout's in turns, parent / change / change / parent; each ``--variant
NAME=V,...`` adds a copy of glue.cu with those constexprs rewritten between
the changes (its hashes beside the others).  Then the wrapper
``glue_products_scan_shift`` of the checkout's package (``--root``) at the
first state, split on the host clock into the launch, the read-back (the
wait for the kernel and the copy to the host) and the unpacking (medians
of ``--reps`` calls; and the copy alone after a synchronize).  ``--glue
--headline``: instead, the headline ``pschur(A, 'R')`` in ``--pairs``
pairs (default 5) that alternate, within one process, kernel G with the
numpy host glue of tests/torch_glue_host.py (``host_glue``, fed by
``pqr_real._BandGather``) in its place, the order flipped from pair to
pair: wall, iteration time, niter, backward error and hashes of T and Z of
every run, and each leg's median and spread; then the headline, the mb leg
and the rg leg with their device time by kernel (G and D included) and
idle share, as ``--ladders --headline`` prints them.

Run from the repository root:
  python3 scripts/time_sweep_generate.py [--cx [--apply [--against DIR] [--variant ...]]
      | --rg [--apply [--against DIR] [--variant ...]] | --hess | --signed [--split]
      | --deflate [--against DIR] | --apply | --mb [--against DIR]
      | --ladders [--against DIR] [--also NAME=DIR] [--variant ...] [--split]
      | --glue [--against DIR] [--variant ...] [--headline [--pairs K]]]
      [--root DIR]
      [--headline [--trace]]
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RG_RUNS = 3  # timed runs of the rg iteration (host-bound: its wall spreads)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--headline", action="store_true")
    ap.add_argument("--cx", action="store_true")
    ap.add_argument("--rg", action="store_true")
    ap.add_argument("--hess", action="store_true")
    ap.add_argument("--signed", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--deflate", action="store_true")
    ap.add_argument("--apply", action="store_true")
    ap.add_argument("--mb", action="store_true")
    ap.add_argument("--ladders", action="store_true")
    ap.add_argument("--glue", action="store_true")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--against", default=None)
    ap.add_argument("--also", action="append", default=[])
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--hq", default=os.path.join(HERE, "_dev", "rg_hq.pt"))
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-out", default=os.path.join(HERE, "_dev", "rg_trace.txt"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path[1:1] = [HERE, os.path.join(HERE, "tests")]
    import torch
    if not torch.cuda.is_available():
        print("time_sweep_generate: no CUDA device", file=sys.stderr)
        return 2
    from periodicschurdecompositions_jl_torch.ops import _cuda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = _cuda.load()
    out = {"root": os.path.abspath(args.root), "card": smi}
    (time_glue if args.glue else time_ladders if args.ladders else time_mb if args.mb else time_cx_apply if args.apply and args.cx else
     time_rg_apply if args.apply and args.rg else time_apply if args.apply else
     time_deflate if args.deflate else time_signed if args.signed else time_hess
     if args.hess else time_cx if args.cx else time_rg if args.rg
     else time_real)(torch, lib, _cuda, args, out)
    print(json.dumps(out))
    return 0


def event_ms(torch, call, reps):
    call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def time_real(torch, lib, _cuda, args, out):
    from chip_smoke import mk_sweep_problem
    p, n = 16, 512
    N = n + 1
    Hn, _, v0 = mk_sweep_problem(p, n, np.random.default_rng(2024))
    H = torch.tensor(Hn, device="cuda")
    work = torch.empty((p, N, N), dtype=torch.float64, device="cuda")
    R = torch.empty((p, N, 9), dtype=torch.float64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    out.update(p=p, n=n)
    for (m, i) in ((0, n - 1), (37, 300), (200, 202)):
        def call():
            _cuda.check(lib.psd_sweep_generate(H.data_ptr(), work.data_ptr(), R.data_ptr(),
                                               p, N, m, i, *map(float, v0), st),
                        "sweep_generate")
        ms = event_ms(torch, call, args.reps)
        out[f"A_ms[{m},{i}]"] = ms
        out[f"A_us_per_step_factor[{m},{i}]"] = ms * 1e3 / ((i - m) * p)
        out[f"R_sha256[{m},{i}]"] = hashlib.sha256(
            R[:, m:i].contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    if args.headline:
        headline_real(torch, out)


def headline_real(torch, out):
    """One real headline pschur (p=16, n=512, seed 12345) after a small
    warm-up call."""
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    pt.pschur(torch.tensor(np.random.default_rng(0).standard_normal((2, 32, 32)),
                           device="cuda"), "R")
    A = torch.tensor(np.random.default_rng(12345).standard_normal((16, 512, 512)),
                     device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P = pt.pschur(A, "R")
    torch.cuda.synchronize()
    out["headline_wall_s"] = time.perf_counter() - t0
    info = pqr_real.last_info
    out["headline_reduce_s"] = info["reduce_s"]
    out["headline_iterate_s"] = info["iterate_s"]
    out["headline_niter"] = info["niter"]
    out["headline_sweeps"] = info["sweeps"]
    out["headline_T_sha256"], out["headline_Z_sha256"] = sha(P.Ts), sha(P.Zs)


def time_cx(torch, lib, _cuda, args, out):
    from chip_smoke import alternating, mk_cx_problem
    p, n = 8, 256
    Hn, _, csn = mk_cx_problem(p, n, np.random.default_rng(2025))
    cs = torch.tensor(csn, device="cuda")
    work = torch.empty((p, n, n), dtype=torch.complex128, device="cuda")
    log = torch.empty((p, n, 16), dtype=torch.complex128, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    out.update(p=p, n=n)
    for sname, S in (("alt", alternating(p)), ("direct", (True,) * p)):
        Sd = torch.tensor([int(x) for x in S], dtype=torch.int32, device="cuda")
        for (m, i) in ((0, n - 1), (37, 200), (120, 122)):
            H0 = torch.tensor(Hn, device="cuda")
            if m > 0:
                H0[0, m, m - 1] = 0.0
            if i + 1 < n:
                H0[0, i + 1, i] = 0.0

            def call():
                _cuda.check(lib.psd_qz_sweep_generate(H0.data_ptr(), work.data_ptr(),
                                                      log.data_ptr(), cs.data_ptr(),
                                                      Sd.data_ptr(), p, n, m, i, st),
                            "qz_sweep_generate")
            ms = event_ms(torch, call, args.reps)
            w = f"{sname}[{m},{i}]"
            out[f"A_ms_{w}"] = ms
            out[f"A_us_per_step_factor_{w}"] = ms * 1e3 / ((i - m) * p)
            # every entry the kernel writes: L, R, ZR of each factor, r of factor 0
            written = torch.cat([log[:, m:i, :12].reshape(-1), log[0, m:i, 12]])
            out[f"log_sha256_{w}"] = hashlib.sha256(
                written.cpu().numpy().tobytes()).hexdigest()[:16]
    if args.headline:
        headline_cx(torch, out)


def headline_cx(torch, out):
    """The complex leg of chip_smoke.py (p=8, n=256, seed 777, no
    signature) after a small warm-up call."""
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.ops import pqz_complex
    p, n = 8, 256
    rng = np.random.default_rng(0)
    pt.pschur(torch.tensor(rng.standard_normal((2, 16, 16))
                           + 1j * rng.standard_normal((2, 16, 16)), device="cuda"), "R")
    rng = np.random.default_rng(777)
    A = torch.tensor(rng.standard_normal((p, n, n)) + 1j * rng.standard_normal((p, n, n)),
                     device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.pschur(A, "R")
    torch.cuda.synchronize()
    out["cx_leg_wall_s"] = time.perf_counter() - t0
    info = pqz_complex.last_info
    out["cx_leg_iterate_s"] = info["iterate_s"]
    out["cx_leg_reduce_s"] = info["reduce_s"]
    out["cx_leg_niter"] = info["niter"]
    out["cx_leg_sweeps"] = info["sweeps"]


def ptxas_report(_cuda, root, name, keys, sets=()):
    """csrc/<name>.cu of ``root`` (each ``constexpr int`` of ``sets``
    rewritten) built alone with ``-Xptxas -v`` into _dev/<name>_<tag>.cubin:
    {kernel: "N registers, stack frame and spill bytes"} for the kernels
    whose mangled names hold one of ``keys``."""
    import re
    csrc = os.path.join(root, "periodicschurdecompositions_jl_torch", "csrc")
    dev = os.path.join(HERE, "_dev")
    os.makedirs(dev, exist_ok=True)
    tag = hashlib.sha256((os.path.abspath(root) + " ".join(sets)).encode()).hexdigest()[:8]
    cu = os.path.join(dev, f"{name}_{tag}.cu")
    open(cu, "w").write(set_constexprs(open(os.path.join(csrc, name + ".cu")).read(), sets,
                                       name + ".cu"))
    log = subprocess.run([_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-cubin",
                          "-I", csrc, "-o", cu[:-3] + ".cubin", cu], capture_output=True,
                         text=True, check=True).stderr
    rep, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and any(k in fn for k in keys):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", line)
            if m:
                rep[fn] = f"stack {m.group(1)} B, spill {m.group(2)}/{m.group(3)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m:
                short = re.sub(r".*?((?:sweep|qz|rg)_(?:left|right)_kernel(?:ILi\d+E)?).*",
                               r"\1", fn)
                rep[short] = f"{m.group(1)} registers, " + rep.pop(fn, "")
                fn = None
    return rep


def time_apply(torch, lib, _cuda, args, out):
    import ctypes
    import importlib.util
    from periodicschurdecompositions_jl_torch.ops import pqr_real, sweep
    # this checkout's chip_smoke.py (its apply_bounds; --root's may predate it)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    MB_GAP, mk_sweep_problem = cs.MB_GAP, cs.mk_sweep_problem
    p, n = 16, 512
    N = n + 1
    out["ptxas"] = ptxas_report(_cuda, args.root, "sweep", ("sweep_left", "sweep_right"),
                                args.set)
    print("ptxas:", json.dumps(out["ptxas"]), flush=True)
    alib = lib
    if args.set:  # B0 and B of a copy of sweep.cu with constexprs rewritten
        alib = build_variant(_cuda, args.root, "sweep", args.set)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        alib.psd_sweep_left.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
        alib.psd_sweep_right.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
        out["set"] = args.set
    Hn, Zn, v0 = mk_sweep_problem(p, n, np.random.default_rng(2024))
    Z0 = torch.tensor(Zn, device="cuda")
    st = torch.cuda.current_stream().cuda_stream

    def left(H, R, m, i, nb):
        _cuda.check(alib.psd_sweep_left(H.data_ptr(), R.data_ptr(), p, N, m, i, nb, st),
                    "sweep_left")

    def right(H, Z, R, m, i, nb):
        _cuda.check(alib.psd_sweep_right(H.data_ptr(), Z.data_ptr(), R.data_ptr(), p, N, m,
                                         i, nb, st), "sweep_right")
    out.update(p=p, n=n)
    for (m, i) in ((0, n - 1), (37, 300), (200, 202)):
        H0 = torch.tensor(Hn, device="cuda")
        if m > 0:
            H0[0, m, m - 1] = 0.0
        H0[0, i + 1, i] = 0.0
        R1 = sweep.sweep_generate(H0, m, i, v0)
        sig = pqr_real.window_shifts(H0, i, 4)
        vals = [float(x) for x in v0] + [float(x) for s3 in sig for x in s3]
        R4 = torch.empty((4, p, N, 9), dtype=torch.float64, device="cuda")
        C = torch.empty((p, N, N), dtype=torch.float64, device="cuda")  # scratch of either design
        _cuda.check(lib.psd_sweep_generate_mb(H0.data_ptr(), C.data_ptr(), R4.data_ptr(), p, N,
                                              m, i, 4, MB_GAP, 4,
                                              (ctypes.c_double * len(vals))(*vals), st),
                    "sweep_generate_mb")
        runs = [(1, R1), (4, R4)] + ([(2, R4), (3, R4)] if m == 0 else [])
        for nb, R in runs:
            key = f"[{m},{i}] nb{nb}"
            H, Z = H0.clone(), Z0.clone()
            left(H, R, m, i, nb)
            right(H, Z, R, m, i, nb)
            out[f"H_sha256 {key}"], out[f"Z_sha256 {key}"] = sha(H), sha(Z)
            H, Z = H0.clone(), Z0.clone()
            out[f"B0_ms {key}"] = event_ms(torch, lambda: left(H, R, m, i, nb), args.reps)
            out[f"B_ms {key}"] = event_ms(torch, lambda: right(H, Z, R, m, i, nb), args.reps)
            bnd = cs.apply_bounds(p, n, m, i, nb)
            for k, name in (("B0", "sweep_left"), ("B", "sweep_right")):
                out[f"{k}_bound_us {key}"] = bnd[name][0] * 1e3
                out[f"{k}_of_bound {key}"] = bnd[name][0] / out[f"{k}_ms {key}"]
            print(f"{key}: B0 {out[f'B0_ms {key}']:.4f} ms ({out[f'B0_of_bound {key}']:.1%} of "
                  f"{out[f'B0_bound_us {key}']:.3f} us), B {out[f'B_ms {key}']:.4f} ms "
                  f"({out[f'B_of_bound {key}']:.1%} of {out[f'B_bound_us {key}']:.3f} us), "
                  f"H {out[f'H_sha256 {key}']} Z {out[f'Z_sha256 {key}']}", flush=True)
        if m == 0:  # what NB logs cost: three one-log launches, one log three times
            H, Z = H0.clone(), Z0.clone()
            out[f"B0_ms [{m},{i}] 3x nb1"] = event_ms(
                torch, lambda: [left(H, R4[b], m, i, 1) for b in range(3)], args.reps)
            out[f"B_ms [{m},{i}] 3x nb1"] = event_ms(
                torch, lambda: [right(H, Z, R4[b], m, i, 1) for b in range(3)], args.reps)
            R000 = R4[:1].repeat(3, 1, 1, 1).contiguous()
            out[f"B0_ms [{m},{i}] nb3 log0x3"] = event_ms(
                torch, lambda: left(H, R000, m, i, 3), args.reps)
            out[f"B_ms [{m},{i}] nb3 log0x3"] = event_ms(
                torch, lambda: right(H, Z, R000, m, i, 3), args.reps)
            print(" ".join(f"{k} {v:.4f}" for k, v in out.items() if "3x" in k or "x3" in k),
                  flush=True)
    for k in ("B0", "B"):
        out[f"{k} nb4/nb1 [0,{n - 1}]"] = out[f"{k}_ms [0,{n - 1}] nb4"] / out[
            f"{k}_ms [0,{n - 1}] nb1"]
    if args.headline:
        headline_real(torch, out)
        headline_apply_profile(torch, out)


# --cx --apply: (p, n, windows) of cx_kernel_phase's draw (default_rng(2025))
# at the complex leg's shape and at the signed complex leg's
CX_APPLY_SHAPES = ((8, 256, ((0, 255), (37, 200), (120, 122))), (8, 128, ((0, 127),)))


def parent_lib(against, decl):
    """``against``'s kernel library, built in a child process; the C entries
    of ``decl`` get this checkout's argument types."""
    import ctypes
    so = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from periodicschurdecompositions_jl_torch.ops import _cuda; "
         "print(_cuda.load()._name)", os.path.abspath(against)],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
    lb = ctypes.CDLL(so)
    for fn in decl:
        getattr(lb, fn).argtypes = decl[fn].argtypes
        getattr(lb, fn).restype = ctypes.c_int
    return lb, so


def load_chip_smoke():
    """This checkout's chip_smoke.py (its bounds and draws), whatever --root."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def apply_libs(_cuda, lib, args, name, entries, keys, out):
    """The libraries of an --apply comparison of csrc/<name>.cu's B0 and B
    (C entries ``entries``): this checkout's ("change"), ``--against``'s
    ("parent", built in a child process) and each ``--variant`` (a copy of
    the source with its constexprs rewritten); the turns parent / change /
    variants / change / parent, and ptxas's report of each (kernels whose
    names hold one of ``keys``).  Returns (libs, order)."""
    decl = {fn: getattr(lib, fn) for fn in entries}
    libs = {"change": lib}
    if args.against:
        libs["parent"], out["parent"] = parent_lib(args.against, decl)
    variants = [v.split(",") for v in args.variant]
    for v in variants:
        libs[" ".join(v)] = build_variant(_cuda, args.root, name, v)
        for fn in decl:
            getattr(libs[" ".join(v)], fn).argtypes = decl[fn].argtypes
    order = ["parent", "change"] if args.against else ["change"]
    order += [" ".join(v) for v in variants]
    order += order[::-1]
    out["order"] = order
    out["ptxas"] = ptxas_report(_cuda, args.root, name, keys)
    if args.against:
        out["ptxas parent"] = ptxas_report(_cuda, args.against, name, keys)
    for v in variants:
        out[f"ptxas {' '.join(v)}"] = ptxas_report(_cuda, args.root, name, keys, v)
    print("ptxas:", json.dumps({k: v for k, v in out.items() if k.startswith("ptxas")}),
          flush=True)
    return libs, order


def apply_turns(torch, libs, order, key, H0, Z0, left, right, bnd, reps, out):
    """One case of an --apply comparison: per library the sha256 of H after
    B0, of H and Z after B and of H after B without Z (on fresh copies of
    H0 and Z0), and in each turn of ``order`` the times of B0 and of B
    (CUDA events, mean of ``reps`` launches after a warm-up); left(lib, H)
    and right(lib, H, Z or None) launch them; bnd: {"B0": ms, "B": ms}, the
    bounds.  Prints one line; returns whether every library's hashes
    agree."""
    hashes = {}
    for tag in order:
        if tag not in hashes:
            H, Z = H0.clone(), Z0.clone()
            left(libs[tag], H)
            hb0 = sha(H)
            right(libs[tag], H, Z)
            Hn_ = H0.clone()
            left(libs[tag], Hn_)
            right(libs[tag], Hn_, None)
            hashes[tag] = (hb0, sha(H), sha(Z), sha(Hn_))
            out[f"{tag} hashes {key}"] = " ".join(hashes[tag])
        H, Z = H0.clone(), Z0.clone()
        out.setdefault(f"{tag} B0_ms {key}", []).append(
            event_ms(torch, lambda: left(libs[tag], H), reps))
        out.setdefault(f"{tag} B_ms {key}", []).append(
            event_ms(torch, lambda: right(libs[tag], H, Z), reps))
    same = len(set(hashes.values())) == 1
    for k in ("B0", "B"):
        out[f"{k}_bound_us {key}"] = bnd[k] * 1e3
        out[f"change {k}_of_bound {key}"] = bnd[k] / min(out[f"change {k}_ms {key}"])
    print(f"{key}: " + "; ".join(
        f"{t} B0 {out[f'{t} B0_ms {key}']} B {out[f'{t} B_ms {key}']} ms"
        for t in libs) + f"; bounds B0 {out[f'B0_bound_us {key}']:.3f} B "
        f"{out[f'B_bound_us {key}']:.3f} us; change at "
        f"{out[f'change B0_of_bound {key}']:.1%} / "
        f"{out[f'change B_of_bound {key}']:.1%}; hashes "
        f"{'equal' if same else 'DIFFER: ' + str(hashes)}", flush=True)
    return same


def time_cx_apply(torch, lib, _cuda, args, out):
    """cx B0 and B (psd_qz_sweep_left / psd_qz_sweep_right) on
    cx_kernel_phase's draw, alternating and all-direct S, on kernel A's own
    log: hashes of H after B0, of H and Z after B, and of H after B without
    Z; the time of B0 and of B (CUDA events, mean of ``--reps`` launches
    after a warm-up) beside chip_smoke.py's bounds; with ``--against DIR``
    in turns parent / change / change / parent in one process, and each
    ``--variant`` (a copy of sweep_cx.cu with its constexprs rewritten)
    between the changes."""
    from periodicschurdecompositions_jl_torch.ops import sweep_cx
    cs = load_chip_smoke()
    libs, order = apply_libs(_cuda, lib, args, "sweep_cx",
                             ("psd_qz_sweep_left", "psd_qz_sweep_right", "psd_qz_shift"),
                             ("qz_left", "qz_right", "qz_shift"), out)
    st = torch.cuda.current_stream().cuda_stream
    equal = True
    for (p, n, windows) in CX_APPLY_SHAPES:
        Hn, Zn, csn = cs.mk_cx_problem(p, n, np.random.default_rng(2025))
        cst = torch.tensor(csn, device="cuda")
        Z0 = torch.tensor(Zn, device="cuda")
        for sname, S in (("alt", cs.alternating(p)), ("direct", (True,) * p)):
            for (m, i) in windows:
                H0 = torch.tensor(Hn, device="cuda")
                if m > 0:
                    H0[0, m, m - 1] = 0.0
                if i + 1 < n:
                    H0[0, i + 1, i] = 0.0
                log = sweep_cx.qz_sweep_generate(H0, m, i, cst, S)

                def left(lb, H):
                    _cuda.check(lb.psd_qz_sweep_left(H.data_ptr(), log.data_ptr(), p, n, m, i,
                                                     st), "qz_sweep_left")

                def right(lb, H, Z):
                    _cuda.check(lb.psd_qz_sweep_right(H.data_ptr(), None if Z is None else
                                                      Z.data_ptr(), log.data_ptr(), p, n, m,
                                                      i, st), "qz_sweep_right")
                bnd = cs.cx_apply_bounds(p, n, m, i)
                equal &= apply_turns(torch, libs, order, f"p{p} n{n} {sname} [{m},{i}]", H0,
                                     Z0, left, right, {"B0": bnd["qz_sweep_left"][0],
                                                       "B": bnd["qz_sweep_right"][0]},
                                     args.reps, out)
    out["hashes_equal"] = equal & shift_turns(torch, _cuda, cs, libs, order, args.reps, out)
    if args.headline:
        headline_cx_profile(torch, out)


def shift_turns(torch, _cuda, cs, libs, order, reps, out):
    """Kernel S (psd_qz_shift) of each library on cx_kernel_phase's draws
    (CX_APPLY_SHAPES' shapes and windows, alternating, all-direct and
    all-inverse-but-S[0] signatures): the sha256 of (c, s) per library and,
    at p=8 n=256 on [0, 255], the time of a launch in turns (CUDA events,
    mean of ``reps`` launches, and the device time under the profiler);
    returns whether every library's hashes agree."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import dev_us
    st = torch.cuda.current_stream().cuda_stream
    equal = True
    for (p, n, windows) in CX_APPLY_SHAPES:
        H0 = torch.tensor(cs.mk_cx_problem(p, n, np.random.default_rng(2025))[0], device="cuda")
        cso = torch.empty(2, dtype=torch.complex128, device="cuda")
        for sname, S in (("alt", cs.alternating(p)), ("direct", (True,) * p),
                         ("inverse", (True,) + (False,) * (p - 1))):
            Sd = torch.tensor([int(x) for x in S], dtype=torch.int32, device="cuda")
            for (m, i) in windows + ((1, n - 2),):
                def call(lb):
                    _cuda.check(lb.psd_qz_shift(H0.data_ptr(), cso.data_ptr(), Sd.data_ptr(), p,
                                                n, m, i, st), "qz_shift")
                hashes = {}
                for tag in libs:
                    cso.fill_(complex("nan"))
                    call(libs[tag])
                    hashes[tag] = sha(cso)
                key = f"S p{p} n{n} {sname} [{m},{i}]"
                same = len(set(hashes.values())) == 1
                equal &= same
                out[f"{key} hashes"] = hashes
                line = f"{key}: hashes {'equal' if same else 'DIFFER: ' + str(hashes)}"
                if (p, n, m, i) == (8, 256, 0, 255) and sname != "inverse":
                    for tag in order:
                        out.setdefault(f"{tag} {key} ms", []).append(
                            event_ms(torch, lambda: call(libs[tag]), reps))
                        torch.cuda.synchronize()
                        with profile(activities=[ProfilerActivity.CUDA]) as prof:
                            for _ in range(reps):
                                call(libs[tag])
                            torch.cuda.synchronize()
                        ev = [e for e in prof.key_averages()
                              if "qz_shift" in e.key and dev_us(e) > 0]
                        out.setdefault(f"{tag} {key} device_us", []).append(
                            sum(dev_us(e) for e in ev) / max(1, sum(e.count for e in ev)))
                    line += "; " + "; ".join(f"{t} {out[f'{t} {key} ms']} ms (device "
                                             f"{out[f'{t} {key} device_us']} us)" for t in libs)
                print(line, flush=True)
    return equal


# rg B0 and B: rg_kernel_phase's shape and windows, and its odd-n window
RG_APPLY_SHAPES = ((8, 256, ((1, 255), (38, 200), (121, 124))), (3, 129, ((1, 128),)))


def time_rg_apply(torch, lib, _cuda, args, out):
    """rg B0 and B (psd_rg_sweep_left / psd_rg_sweep_right) on
    rg_kernel_phase's draw (``default_rng(2026)``, the window's boundaries
    deflated, the opening ladder applied), alternating and all-direct S,
    on kernel rg A's own log, as ``time_cx_apply``; bounds from
    chip_smoke.py's ``rg_apply_bounds``."""
    from periodicschurdecompositions_jl_torch.ops import sweep_rg
    cs = load_chip_smoke()
    libs, order = apply_libs(_cuda, lib, args, "sweep_rg",
                             ("psd_rg_sweep_left", "psd_rg_sweep_right"),
                             ("rg_left", "rg_right"), out)
    st = torch.cuda.current_stream().cuda_stream
    equal = True
    for (p, n, windows) in RG_APPLY_SHAPES:
        for sname, S in (("alt", cs.alternating(p)), ("direct", (True,) * p)):
            for (m, i) in windows:
                H0, Z0 = rg_state(torch, p, n, m, i, S)
                log = sweep_rg.rg_sweep_generate(H0, m, i, S)

                def left(lb, H):
                    _cuda.check(lb.psd_rg_sweep_left(H.data_ptr(), log.data_ptr(), p, n, m, i,
                                                     st), "rg_sweep_left")

                def right(lb, H, Z):
                    _cuda.check(lb.psd_rg_sweep_right(H.data_ptr(), None if Z is None else
                                                      Z.data_ptr(), log.data_ptr(), p, n, m,
                                                      i, st), "rg_sweep_right")
                bnd = cs.rg_apply_bounds(p, n, m, i)
                equal &= apply_turns(torch, libs, order, f"p{p} n{n} {sname} [{m},{i}]", H0,
                                     Z0, left, right, {"B0": bnd["rg_sweep_left"][0],
                                                       "B": bnd["rg_sweep_right"][0]},
                                     args.reps, out)
    out["hashes_equal"] = equal
    if args.headline:
        headline_rg_profile(torch, out)


def headline_rg_profile(torch, out):
    """The rg leg of chip_smoke.py (``pschur(A, 'R', S)``, p=8, n=256, seed
    4242, alternating S) after a small warm-up: wall, reduction, iteration,
    niter, sweeps, hashes of T and Z; then once more under the CUDA
    profiler: the device time and launches of rg A, B0, B, R and CZSHIFT
    and the idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    import periodicschurdecompositions_jl_torch as pt
    from chip_smoke import dev_us, rg_draw
    from periodicschurdecompositions_jl_torch.ops import pqz_real
    Aw, Sw = rg_draw(4, 24, 1)
    pt.pschur(torch.tensor(Aw, device="cuda"), "R", S=Sw)
    A, S = rg_draw(8, 256, 4242)
    A = torch.tensor(A, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P = pt.pschur(A, "R", S=S)
    torch.cuda.synchronize()
    out["rg wall_s"] = time.perf_counter() - t0
    info = pqz_real.last_info
    for k in ("reduce_s", "iterate_s", "niter", "sweeps"):
        out[f"rg {k}"] = info[k]
    out["rg T_sha256"], out["rg Z_sha256"] = sha(P.Ts), sha(P.Zs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pt.pschur(A, "R", S=S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type) and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in ev) / 1e3
    out["rg profiled_wall_s"], out["rg device_ms"] = wall, busy
    out["rg idle_share"] = 1 - busy / 1e3 / wall
    for tag, key in (("A", "rg_generate_kernel"), ("B0", "rg_left_kernel"),
                     ("B", "rg_right_kernel"), ("R", "rg_ladder_kernel"),
                     ("CZSHIFT", "czshift")):
        sel = [e for e in ev if key in e.key]
        out[f"rg {tag}_device_ms"] = sum(dev_us(e) for e in sel) / 1e3
        out[f"rg {tag}_launches"] = sum(e.count for e in sel)
    print("rg leg: " + ", ".join(f"{k[3:]} {v}" for k, v in out.items()
                                 if k.startswith("rg ")), flush=True)


def headline_cx_profile(torch, out):
    """The complex leg (p=8, n=256, seed 777, no signature) and the signed
    complex leg (p=8, n=128, alternating S) of chip_smoke.py, each after a
    small warm-up: wall, iteration, niter, sweeps, hashes of T and Z; then
    once more under the CUDA profiler: the device time and launches of cx A,
    B0, B and S and the idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    import periodicschurdecompositions_jl_torch as pt
    from chip_smoke import alternating, cx_draw, dev_us
    from periodicschurdecompositions_jl_torch.ops import pqz_complex
    rng = np.random.default_rng(0)
    pt.pschur(torch.tensor(rng.standard_normal((2, 16, 16))
                           + 1j * rng.standard_normal((2, 16, 16)), device="cuda"), "R")
    for leg, n, S in (("cx", 256, None), ("signed cx", 128, alternating(8))):
        A = torch.tensor(cx_draw(8, n, 777), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P = pt.pschur(A, "R", S=S)
        torch.cuda.synchronize()
        out[f"{leg} wall_s"] = time.perf_counter() - t0
        info = pqz_complex.last_info
        for k in ("reduce_s", "iterate_s", "niter", "sweeps"):
            out[f"{leg} {k}"] = info[k]
        out[f"{leg} T_sha256"], out[f"{leg} Z_sha256"] = sha(P.Ts), sha(P.Zs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pt.pschur(A, "R", S=S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type) and dev_us(e) > 0]
        busy = sum(dev_us(e) for e in ev) / 1e3
        out[f"{leg} profiled_wall_s"], out[f"{leg} device_ms"] = wall, busy
        out[f"{leg} idle_share"] = 1 - busy / 1e3 / wall
        for tag, key in (("A", "qz_generate_kernel"), ("B0", "qz_left_kernel"),
                         ("B", "qz_right_kernel"), ("S", "qz_shift_kernel")):
            sel = [e for e in ev if key in e.key]
            out[f"{leg} {tag}_device_ms"] = sum(dev_us(e) for e in sel) / 1e3
            out[f"{leg} {tag}_launches"] = sum(e.count for e in sel)
        print(f"{leg} leg: " + ", ".join(f"{k[len(leg) + 1:]} {v}" for k, v in out.items()
                                         if k.startswith(leg + " ")), flush=True)


def mb_windows(n):
    """(m, i, nb, nbact) of ``--mb``: [0, n-1] with NB = 1..4 (all active),
    and chip_smoke.py's mb_phase windows [0, 127] (four bulges) and
    [200, 263] (two of four)."""
    return [(0, n - 1, nb, nb) for nb in (1, 2, 3, 4)] + [(0, 127, 4, 4), (200, 263, 4, 2)]


def time_mb(torch, lib, _cuda, args, out):
    """Kernel A-mb alone on mb_phase's draw (p=16, n=512, default_rng(2027)),
    gap 3, the driver's window shifts; with ``--against DIR`` in rounds of
    parent (DIR's library) and change (this checkout's), P C C P, each the
    mean of ``--reps`` launches after a warm-up, CUDA events.  The scratch
    is a (p, N, N) buffer: the working copy of the design before the
    look-ahead window, more than the carried rows of the window's."""
    import ctypes
    from chip_smoke import mk_sweep_problem
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    p, n = 16, 512
    N = n + 1
    libs = {"change": lib}
    if args.against:
        libs["parent"], out["parent"] = parent_lib(
            args.against, {"psd_sweep_generate_mb": lib.psd_sweep_generate_mb})
    if args.set:  # A-mb of a copy of sweep.cu with constexprs rewritten, in the turns
        libs["set"] = build_variant(_cuda, HERE, "sweep", args.set)
        libs["set"].psd_sweep_generate_mb.argtypes = lib.psd_sweep_generate_mb.argtypes
        out["set"] = args.set
    order = ["parent", "change", "change", "parent"] if args.against else ["change"]
    if args.set:
        order = order[:len(order) // 2] + ["set", "set"] + order[len(order) // 2:]
    Hn, _, v0 = mk_sweep_problem(p, n, np.random.default_rng(2027))
    st = torch.cuda.current_stream().cuda_stream
    work = torch.empty((p, N, N), dtype=torch.float64, device="cuda")
    out.update(p=p, n=n, gap=3, order=order)
    for (m, i, nb, nbact) in mb_windows(n):
        H = torch.tensor(Hn, device="cuda")
        if m > 0:
            H[0, m, m - 1] = 0.0
        H[0, i + 1, i] = 0.0
        sig = pqr_real.window_shifts(H, i, nb)
        vals = [float(x) for x in v0] + [float(x) for s3 in sig for x in s3]
        shifts = (ctypes.c_double * len(vals))(*vals)
        R = torch.empty((nb, p, N, 9), dtype=torch.float64, device="cuda")
        key = f"[{m},{i}] nb{nb} nbact{nbact}"
        for tag in order:
            def call():
                _cuda.check(libs[tag].psd_sweep_generate_mb(
                    H.data_ptr(), work.data_ptr(), R.data_ptr(), p, N, m, i, nb, 3, nbact,
                    shifts, st), "sweep_generate_mb")
            out.setdefault(f"{tag} A-mb ms {key}", []).append(event_ms(torch, call, args.reps))
            out[f"{tag} R_sha256 {key}"] = sha(R[:nbact, :, m:i])
        ticks = i - m + (nbact - 1) * 3
        ms = out[f"change A-mb ms {key}"]
        out[f"change us per (tick, factor) {key}"] = min(ms) * 1e3 / (ticks * p)
        print(key + ": " + ", ".join(f"{t} {out[f'{t} A-mb ms {key}']} ms R "
                                     f"{out[f'{t} R_sha256 {key}']}" for t in libs), flush=True)
    if args.split:
        split_mb(torch, _cuda, lib, args, Hn, v0, out)
    if args.headline:
        headline_mb(torch, out)


# --mb --split: copies of sweep.cu with parts of A-mb cut, as (regex,
# replacement) pairs (their logs are wrong; only their times count): the
# rest warps' work (mb_rest), and also the band rows and window updates that
# warp 0 applies after its generations
MB_REST = (r"\n      if \(threadIdx\.x >= 32\) mb_rest\([^;]*;", "")
MB_WARP0 = (r"crit \? min\(|\bmb_window_step\((?=win)",
            lambda m: "false ? min(" if "crit" in m.group(0) else "if (0) mb_window_step(")
MB_CUTS = {"no rest warps": [MB_REST], "generations only": [MB_REST, MB_WARP0]}


def split_mb(torch, _cuda, lib, args, Hn, v0, out):
    """A-mb of this checkout with the cuts of MB_CUTS, each built alone
    into _dev/ (in parallel), at [0, 511] with NB = 1 and 4: where its time
    goes (the generations' chain, the updates on its path, the rest).  The
    scratch is zeroed, so a cut that leaves it unwritten reads zeros."""
    import ctypes
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    csrc = os.path.join(HERE, "periodicschurdecompositions_jl_torch", "csrc")
    src = open(os.path.join(csrc, "sweep.cu")).read()
    dev = os.path.join(HERE, "_dev")
    os.makedirs(dev, exist_ok=True)
    import re
    cuts = {}
    for name, subs in MB_CUTS.items():
        cut = src
        for old, new in subs:
            cut, k = re.subn(old, new, cut)
            if k == 0:
                raise SystemExit(f"--split: {old!r} not in sweep.cu")
        cuts[name] = cut
    procs = {}
    for name, cut in cuts.items():
        cu = os.path.join(dev, "sweep_mb_" + name.replace(" ", "_") + ".cu")
        open(cu, "w").write(cut)
        procs[name] = (cu, subprocess.Popen(
            [_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", csrc, "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"source": lib}
    for name, (cu, pr) in procs.items():
        log = pr.communicate()[0]
        if pr.returncode:
            raise SystemExit(log)
        libs[name] = ctypes.CDLL(cu[:-3] + ".so")
        libs[name].psd_sweep_generate_mb.argtypes = lib.psd_sweep_generate_mb.argtypes
    p, n = Hn.shape[0], Hn.shape[1] - 1
    N = n + 1
    st = torch.cuda.current_stream().cuda_stream
    H = torch.tensor(Hn, device="cuda")
    H[0, n, n - 1] = 0.0
    work = torch.zeros((p, N, N), dtype=torch.float64, device="cuda")
    for nb in (1, 4):
        sig = pqr_real.window_shifts(H, n - 1, nb)
        vals = [float(x) for x in v0] + [float(x) for s3 in sig for x in s3]
        shifts = (ctypes.c_double * len(vals))(*vals)
        R = torch.empty((nb, p, N, 9), dtype=torch.float64, device="cuda")
        for name, lb in libs.items():
            def call():
                work.zero_()
                _cuda.check(lb.psd_sweep_generate_mb(H.data_ptr(), work.data_ptr(), R.data_ptr(),
                                                     p, N, 0, n - 1, nb, 3, nb, shifts, st),
                            "sweep_generate_mb")
            out[f"split [0,{n - 1}] nb{nb} {name} ms"] = event_ms(torch, call, args.reps)
        print(f"split nb{nb}: " + ", ".join(f"{k} {out[f'split [0,{n - 1}] nb{nb} {k} ms']:.3f}"
                                          for k in libs) + " ms", flush=True)


def headline_mb(torch, out):
    """The mb headline leg (p=16, n=512, seed 12345, nbulges=4, gap 3):
    ``pschur_real_pipeline`` after a small warm-up: wall, iteration,
    niter, sweeps, hashes of T and Z, the host time of the shift solve
    (``pqr_real._mb_shifts``: the window gather, its copy to the host and
    ``ops/smallschur.py``), then once more under the CUDA profiler: device
    time and launches by kernel, and the idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import dev_us
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    cfg = AlgoConfig(nbulges=4, bulge_gap=3)
    shift_s = []
    solve = pqr_real._mb_shifts

    def timed(*a, **k):
        t0 = time.perf_counter()
        r = solve(*a, **k)
        shift_s.append(time.perf_counter() - t0)
        return r
    pqr_real._mb_shifts = timed
    pqr_real.pschur_real_pipeline(torch.tensor(
        np.random.default_rng(0).standard_normal((2, 32, 32)), device="cuda"), "R", cfg=cfg)
    A = torch.tensor(np.random.default_rng(12345).standard_normal((16, 512, 512)),
                     device="cuda")
    shift_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P = pqr_real.pschur_real_pipeline(A, "R", cfg=cfg)
    torch.cuda.synchronize()
    out["mb_leg_wall_s"] = time.perf_counter() - t0
    info = pqr_real.last_info
    for k in ("reduce_s", "iterate_s", "niter", "sweeps", "bulges"):
        out[f"mb_leg_{k}"] = info[k]
    out["mb_leg_shift_solve_s"], out["mb_leg_shift_solves"] = sum(shift_s), len(shift_s)
    out["mb_leg_T_sha256"], out["mb_leg_Z_sha256"] = sha(P.Ts), sha(P.Zs)
    pqr_real._mb_shifts = solve
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pqr_real.pschur_real_pipeline(A, "R", cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type) and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in ev) / 1e3
    out["mb_leg_profiled_wall_s"], out["mb_leg_device_ms"] = wall, busy
    out["mb_leg_idle_share"] = 1 - busy / 1e3 / wall
    for tag, key in (("A-mb", "sweep_generate_mb_kernel"), ("B0", "sweep_left_kernel"),
                     ("B", "sweep_right_kernel"), ("G", "glue_kernel"),
                     ("D", "deflate2x2_kernel"), ("reduction", "hess_reduce_kernel")):
        sel = [e for e in ev if key in e.key]
        out[f"mb_leg_{tag}_device_ms"] = sum(dev_us(e) for e in sel) / 1e3
        out[f"mb_leg_{tag}_launches"] = sum(e.count for e in sel)
    named = ("sweep_generate_mb_kernel", "sweep_left_kernel", "sweep_right_kernel",
             "glue_kernel", "deflate2x2_kernel", "hess_reduce_kernel")
    out["mb_leg_other_device_ms"] = sum(dev_us(e) for e in ev
                                        if not any(k in e.key for k in named)) / 1e3
    print("mb leg: " + ", ".join(f"{k[7:]} {v}" for k, v in out.items()
                                 if k.startswith("mb_leg_")), flush=True)


def headline_apply_profile(torch, out):
    """One more headline pschur under the CUDA profiler: the device time of
    kernels A, B0 and B and of the whole run, and their launches."""
    from torch.profiler import ProfilerActivity, profile
    import periodicschurdecompositions_jl_torch as pt
    A = torch.tensor(np.random.default_rng(12345).standard_normal((16, 512, 512)),
                     device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pt.pschur(A, "R")
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "CUDA" in str(e.device_type)]

    def us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
    out["headline_device_ms"] = sum(us(e) for e in ev) / 1e3
    for tag, key in (("A", "sweep_generate_kernel"), ("B0", "sweep_left_kernel"),
                     ("B", "sweep_right_kernel"), ("D", "deflate2x2"), ("G", "glue_kernel")):
        sel = [e for e in ev if key in e.key]
        out[f"headline_{tag}_device_ms"] = sum(us(e) for e in sel) / 1e3
        out[f"headline_{tag}_launches"] = sum(e.count for e in sel)


def ladder_cases(torch, cs, _cuda):
    """--ladders: (kernel, name, H0, Z0, call(lib, H, Z or None), timed)
    for D's and R's cases; ``call`` launches the C entry."""
    from periodicschurdecompositions_jl_torch.ops import rgopen
    st = torch.cuda.current_stream().cuda_stream
    out = []
    p, n = 16, 512
    N = n + 1
    dcases = cs.deflate_cases(p, n)
    for label, Hn, Zn, i in dcases + [("chainB-replace",) + dcases[1][1:]]:
        sc = cs.deflate_scalars(Hn, i)
        rep = int(sc["replace0"] or label == "chainB-replace")
        a = (i, int(sc["jmin"]), int(sc["jmax"]), rep, int(sc["finzero"]), float(sc["cs0"]),
             float(sc["sn0"]), float(sc["thr"]))

        def call(lb, H, Z, a=(p, N) + a):
            _cuda.check(lb.psd_deflate2x2(H.data_ptr(), None if Z is None else Z.data_ptr(),
                                          *a, st), "deflate2x2")
        out.append(("D", f"{label} p{p} n{n} i{i}", torch.tensor(Hn, device="cuda"),
                    torch.tensor(Zn, device="cuda"), call, True))
    p, n = 8, 256
    Hn, Zn, rotn = cs.mk_rg_problem(p, n, np.random.default_rng(2026))
    S = cs.alternating(p)
    Sd = torch.tensor([int(x) for x in S], dtype=torch.int32, device="cuda")
    rot = torch.tensor(rotn, device="cuda")
    timed = {("open", 0), ("close", n - 2), ("chain", 100)}
    for mode, j, il in [("open", 0, n - 1), ("open", 37, 200), ("close", n - 2, n - 1),
                        ("close", 199, 200), ("chain", 100, 101), ("chain", n - 2, n - 1)]:
        for bd in ({}, {"rhi": il + 1, "clo": max(j - 5, 0)}):
            def call(lb, H, Z, a=(p, n, rgopen.MODES[mode], j, il, bd.get("rhi", n),
                                  bd.get("clo", 0))):
                _cuda.check(lb.psd_rg_ladder(H.data_ptr(), None if Z is None else Z.data_ptr(),
                                             rot.data_ptr(), Sd.data_ptr(), *a, st), "rg_ladder")
            out.append(("R", f"{mode} at {j} p{p} n{n}" + (" bounded" if bd else ""),
                        torch.tensor(Hn, device="cuda"), torch.tensor(Zn, device="cuda"),
                        call, not bd and (mode, j) in timed))
    return out


# --ladders --split: timing-only copies of deflate.cu and rgopen.cu (their
# results are not the kernels'): thread 0 skips the chain; no line is
# loaded or stored and one block runs
LADDER_NO_CHAIN = [
    ("bool last = chain_round(W, Lr, p, jmin, fmin, replace, cs0, sn0, thr);",
     "bool last = true;"),
    ("    if (mode == 0)\n      chain_open(W, L, R, Sm, p, bx, ilast);\n    else\n"
     "      chain510(W, E, L, R, Sm, p, mode, bx);", "    (void)bx;")]
LADDER_NO_LINES = [
    ("if (k >= (long)p * Lf) return ln;", "return ln;"),
    ("if (k >= ln.total(p)) return x;", "return x;"),
    ("const long lines = (long)p * ((N - 1 - i) + (i - 1) + (Z ? N : 0));",
     "const long lines = 0;"),
    ("const long lines = ln.total(p);", "const long lines = 0;")]
SPLIT = ("no chain", "no lines")


def ladder_copy(root, tag, subs, files=("deflate.cu", "rgopen.cu"), what="ladders"):
    """A copy of ``root``'s package under _dev/<what>_<tag>/ with each
    (old, new) of ``subs`` that occurs in one of ``files`` (csrc/) replaced
    there (every one must occur in one of them); its directory."""
    import shutil
    pkg = "periodicschurdecompositions_jl_torch"
    d = os.path.join(HERE, "_dev", f"{what}_{tag}")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(root, pkg), os.path.join(d, pkg),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    found = set()
    for name in files:
        path = os.path.join(d, pkg, "csrc", name)
        src = open(path).read()
        for old, new in subs:
            if old in src:
                src = src.replace(old, new)
                found.add(old)
        open(path, "w").write(src)
    missing = [old for old, _ in subs if old not in found]
    if missing:
        raise SystemExit(f"--{what} {tag}: not in {' or '.join(files)}: {missing}")
    return d


def time_ladders(torch, lib, _cuda, args, out):
    """Kernels D and R: hashes of H and Z after one call (fresh copies; and
    H without Z) per library, and in turns parent / change / change /
    parent the time of the timed cases (CUDA events, mean of ``--reps``
    calls in place after a warm-up) beside chip_smoke.py's bounds."""
    cs = load_chip_smoke()
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import dev_us
    decl = {fn: getattr(lib, fn) for fn in ("psd_deflate2x2", "psd_rg_ladder")}
    libs = {"change": lib}
    if args.against:
        libs["parent"], out["parent"] = parent_lib(args.against, decl)
    also = dict(a.split("=", 1) for a in args.also)
    for v in args.variant:  # the source with constexprs rewritten
        also[v] = ladder_copy(args.root, v.replace("=", "").replace(",", "_"), [
            (f"constexpr int {kv.split('=')[0]} = ", f"constexpr int {kv.split('=')[0]} = "
             f"{kv.split('=')[1]}; //") for kv in v.split(",")])
    if args.split:
        also["no chain"] = ladder_copy(args.root, "nochain", LADDER_NO_CHAIN)
        also["no lines"] = ladder_copy(args.root, "nolines", LADDER_NO_LINES)
    for tag, d in also.items():
        libs[tag] = parent_lib(d, decl)[0]
    order = (["parent", "change"] if args.against else ["change"]) + list(also)
    order += order[::-1]
    out["order"] = order
    out["ptxas"] = {k: v for name, keys in (("deflate", ("deflate2x2",)),
                                            ("rgopen", ("rg_ladder",)))
                    for k, v in ptxas_report(_cuda, args.root, name, keys).items()}
    if args.against:
        out["ptxas parent"] = {k: v for name, keys in (("deflate", ("deflate2x2",)),
                                                       ("rgopen", ("rg_ladder",)))
                               for k, v in ptxas_report(_cuda, args.against, name,
                                                        keys).items()}
    print("ptxas:", json.dumps({k: v for k, v in out.items() if k.startswith("ptxas")}),
          flush=True)
    bounds = {"D": cs.deflate_bound(16, 512)[0], "R": cs.ladder_bound(8, 256)[0]}
    equal = True
    for kern, name, H0, Z0, call, timed in ladder_cases(torch, cs, _cuda):
        hashes = {}
        for tag in libs:
            if tag in SPLIT:
                continue
            H, Z = H0.clone(), Z0.clone()
            call(libs[tag], H, Z)
            Hn_ = H0.clone()
            call(libs[tag], Hn_, None)
            hashes[tag] = (sha(H), sha(Z), sha(Hn_))
            out[f"{tag} hashes {kern} {name}"] = " ".join(hashes[tag])
        same = len(set(hashes.values())) == 1
        equal &= same
        line = f"{kern} {name}: hashes {'equal' if same else 'DIFFER: ' + str(hashes)}"
        if timed:
            key = "deflate2x2" if kern == "D" else "rg_ladder"
            for tag in order:
                H, Z = H0.clone(), Z0.clone()
                out.setdefault(f"{tag} {kern}_ms {name}", []).append(
                    event_ms(torch, lambda: call(libs[tag], H, Z), args.reps))
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.reps):
                        call(libs[tag], H, Z)
                    torch.cuda.synchronize()
                ev = [e for e in prof.key_averages() if key in e.key and dev_us(e) > 0]
                out.setdefault(f"{tag} {kern}_device_us {name}", []).append(
                    sum(dev_us(e) for e in ev) / max(1, sum(e.count for e in ev)))
            out[f"{kern}_bound_us"] = bounds[kern] * 1e3
            line += "; " + "; ".join(
                f"{t} {out[f'{t} {kern}_ms {name}']} ms (device "
                f"{out[f'{t} {kern}_device_us {name}']} us)" for t in libs)
            line += f"; bound {bounds[kern] * 1e3:.3f} us"
        print(line, flush=True)
    out["hashes_equal"] = equal
    if args.headline:
        headline_real(torch, out)
        headline_apply_profile(torch, out)
        print("headline: " + ", ".join(f"{k[9:]} {v}" for k, v in out.items()
                                       if k.startswith("headline_")), flush=True)
        headline_mb(torch, out)
        headline_rg_profile(torch, out)


GLUE_STATES = ("call 0", "its==10", "its>=16", "lnew>0")


def time_glue(torch, lib, _cuda, args, out):
    """Kernel G at the headline's states, in turns against ``--against``,
    and the split of its wrapper; ``--headline``: the paired legs against
    the host glue and the legs' device time by kernel."""
    cs = load_chip_smoke()
    if args.headline:
        headline_glue_pairs(torch, cs, args.pairs, out)
        headline_real(torch, out)
        headline_apply_profile(torch, out)
        print("headline: " + ", ".join(f"{k[9:]} {v}" for k, v in out.items()
                                       if k.startswith("headline_")), flush=True)
        headline_mb(torch, out)
        headline_rg_profile(torch, out)
        return
    from torch.profiler import ProfilerActivity, profile
    import periodicschurdecompositions_jl_torch as pt
    from chip_smoke import dev_us
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import glue
    libs = {"change": lib}
    if args.against:
        libs["parent"], out["parent"] = parent_lib(args.against, {"psd_glue": lib.psd_glue})
    for v in args.variant:  # the source with constexprs rewritten
        d = ladder_copy(args.root, v.replace("=", "").replace(",", "_"), [
            (f"constexpr int {kv.split('=')[0]} = ", f"constexpr int {kv.split('=')[0]} = "
             f"{kv.split('=')[1]}; //") for kv in v.split(",")], ("glue.cu",), "glue")
        libs[v] = parent_lib(d, {"psd_glue": lib.psd_glue})[0]
    order = (["parent", "change"] if args.against else ["change"]) + list(args.variant)
    order += order[::-1]
    out["order"] = order
    out["ptxas"] = ptxas_report(_cuda, args.root, "glue", ("glue",))
    if args.against:
        out["ptxas parent"] = ptxas_report(_cuda, args.against, "glue", ("glue",))
    print("ptxas:", json.dumps({k: v for k, v in out.items() if k.startswith("ptxas")}),
          flush=True)
    A = torch.tensor(np.random.default_rng(12345).standard_normal((16, 512, 512)),
                     device="cuda")
    with cs.capture_glue_states() as cap:
        pt.pschur(A, "R")
    states = cap.states
    st = torch.cuda.current_stream().cuda_stream
    cfg = AlgoConfig()
    equal = True
    for label in GLUE_STATES:
        _, Hp, l, i, its = states[label]
        p, N, _ = Hp.shape
        n = N - 1
        k = glue.out_len(p, n)
        # a buffer for each library, zeroed (as a kernel that keeps its
        # block counter from launch to launch needs)
        bufs = {tag: torch.zeros(k + 3 * n, dtype=torch.float64, device="cuda")
                for tag in libs}
        ulp, ulpx, smlnum = glue.scan_constants(n, cfg)

        def call(lb, tag):
            buf = bufs[tag]
            _cuda.check(lb.psd_glue(Hp.data_ptr(), buf.data_ptr(), buf[k:].data_ptr(), p, n,
                                    l, i, its, 0, 0, ulp, ulpx, smlnum, st), "glue")
        hashes = {}
        for tag in libs:
            bufs[tag][:k].fill_(float("nan"))
            call(libs[tag], tag)
            hashes[tag] = sha(bufs[tag][:k])
            out[f"{tag} hash {label}"] = hashes[tag]
        buf = bufs["change"]
        same = len(set(hashes.values())) == 1
        equal &= same
        key = f"{label} (l={l}, i={i}, its={its}, lnew={int(buf[0])})"
        for tag in order:
            out.setdefault(f"{tag} G_ms {label}", []).append(
                event_ms(torch, lambda: call(libs[tag], tag), args.reps))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    call(libs[tag], tag)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if "glue_kernel" in e.key and dev_us(e) > 0]
            out.setdefault(f"{tag} G_device_us {label}", []).append(
                sum(dev_us(e) for e in ev) / max(1, sum(e.count for e in ev)))
            # the counter's memset before each launch, where the library issues one
            ev = [e for e in prof.key_averages() if "emset" in e.key and dev_us(e) > 0]
            out.setdefault(f"{tag} memset_device_us {label}", []).append(
                sum(dev_us(e) for e in ev) / args.reps)
        bms = cs.bound(8 * (3 * p * n + k), 8 * p * n + 25 * (i - l) + 80)[0]
        out["G_bound_us"] = bms * 1e3
        print(f"G {key}: " + "; ".join(
            f"{t} {out[f'{t} G_ms {label}']} ms (device {out[f'{t} G_device_us {label}']} us, "
            f"memset {out[f'{t} memset_device_us {label}']} us)"
            for t in libs) + f"; bound {bms * 1e3:.4f} us; hashes "
            f"{'equal' if same else 'DIFFER: ' + str(hashes)}", flush=True)
    out["hashes_equal"] = equal
    glue_wrapper_split(torch, states["call 0"], args.reps, out)


def glue_wrapper_split(torch, state, reps, out):
    """The checkout's ``glue_products_scan_shift`` at one state on the host
    clock: the whole call, and its launch, read-back (the wait for the
    kernel and the copy) and unpacking in the order the wrapper runs them,
    medians of ``reps`` calls after a warm-up; and the copy alone after a
    synchronize.  A wrapper that reuses buffers (``glue.glue_buffers``) is
    split as the wrapper runs them, the one before through ``glue_cuda``
    and ``.cpu()``."""
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import glue
    _, Hp, l, i, its = state
    p, N, _ = Hp.shape
    n = N - 1
    cfg = AlgoConfig()
    b = glue.glue_buffers(Hp, n) if hasattr(glue, "glue_buffers") else None
    if b is not None:

        def launch():
            stream = torch.cuda.current_stream(Hp.device)
            glue._check_window(Hp, n, l, i)
            glue._launch(Hp, p, n, l, i, its, cfg, b.dev.data_ptr(), stream.cuda_stream)
            return stream

        def read(stream):
            return b.read(stream)

        def unpack(g):
            return glue.unpack(g, p, n, i, b.entries)
    else:
        def launch():
            return glue.glue_cuda(Hp, n, l, i, its, cfg)

        def read(buf):
            return buf.cpu().numpy()

        def unpack(g):
            return glue.unpack(g, p, n, i)
    clock = time.perf_counter
    split = {"launch": [], "read": [], "unpack": [], "copy alone": [], "call": []}
    for rep in range(reps + 1):
        t0 = clock()
        buf = launch()
        t1 = clock()
        g = read(buf)
        t2 = clock()
        unpack(g)
        t3 = clock()
        torch.cuda.synchronize()
        t4 = clock()
        read(buf)
        t5 = clock()
        if b is None:
            glue.glue_products_scan_shift(Hp, n, l, i, its, cfg)
        else:
            glue.glue_products_scan_shift(Hp, n, l, i, its, cfg, b)
        t6 = clock()
        if rep:
            for key, dt in (("launch", t1 - t0), ("read", t2 - t1), ("unpack", t3 - t2),
                            ("copy alone", t5 - t4), ("call", t6 - t5)):
                split[key].append(dt * 1e6)
    for key, v in split.items():
        out[f"wrapper {key} us"] = float(np.median(v))
        out[f"wrapper {key} us spread"] = [float(np.min(v)), float(np.max(v))]
    print("wrapper (host clock, medians of us): " + ", ".join(
        f"{key} {out[f'wrapper {key} us']:.2f} ({out[f'wrapper {key} us spread'][0]:.2f}-"
        f"{out[f'wrapper {key} us spread'][1]:.2f})" for key in split), flush=True)


def headline_glue_pairs(torch, cs, pairs, out):
    """The headline in ``pairs`` pairs of runs, kernel G against the host
    glue in its place (alternating, the order flipped from pair to pair):
    wall, iteration, niter, backward error, hashes of T and Z per run; the
    median and spread of each leg."""
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    from torch_glue_host import host_glue
    pt.pschur(torch.tensor(np.random.default_rng(0).standard_normal((2, 32, 32)),
                           device="cuda"), "R")
    An = np.random.default_rng(12345).standard_normal((16, 512, 512))
    A = torch.tensor(An, device="cuda")
    legs = {"G": pqr_real.glue_products_scan_shift, "host": host_glue}
    runs = {leg: [] for leg in legs}
    if pairs <= 0:
        return
    try:
        for k in range(pairs):
            for leg in (("G", "host") if k % 2 == 0 else ("host", "G")):
                pqr_real.glue_products_scan_shift = legs[leg]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                P = pt.pschur(A, "R")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                info = pqr_real.last_info
                T, Z = P.Ts.cpu().numpy(), P.Zs.cpu().numpy()
                run = {"wall_s": wall, "iterate_s": info["iterate_s"], "niter": info["niter"],
                       "backerr": cs.backerr(An, T, Z), "T": sha(P.Ts), "Z": sha(P.Zs)}
                runs[leg].append(run)
                print(f"pair {k} {leg}: " + ", ".join(f"{a} {b}" for a, b in run.items()),
                      flush=True)
    finally:
        pqr_real.glue_products_scan_shift = legs["G"]
    for leg, rs in runs.items():
        for key in ("wall_s", "iterate_s"):
            v = [r[key] for r in rs]
            out[f"pairs {leg} {key}"] = v
            out[f"pairs {leg} {key} median"] = float(np.median(v))
            out[f"pairs {leg} {key} spread"] = [min(v), max(v)]
        for key in ("niter", "backerr", "T", "Z"):
            out[f"pairs {leg} {key}"] = sorted({r[key] for r in rs})
    out["pairs same T and Z"] = len({(r["T"], r["Z"]) for rs in runs.values() for r in rs}) == 1
    print("pairs: " + ", ".join(f"{k[6:]} {v}" for k, v in out.items()
                                if k.startswith("pairs ") and ("median" in k or "spread" in k
                                                               or "same" in k or "niter" in k
                                                               or "backerr" in k)), flush=True)


def set_constexprs(src, sets, fname):
    """src with each ``constexpr int NAME`` of ``sets`` ("NAME=VALUE")
    rewritten."""
    import re
    for kv in sets:
        key, val = kv.split("=")
        src, k = re.subn(rf"constexpr int {key} = [^;]*;", f"constexpr int {key} = {val};",
                         src)
        if k != 1:
            raise SystemExit(f"--set {kv}: no constexpr int {key} in {fname}")
    return src


def build_variant(_cuda, root, name, sets):
    """csrc/<name>.cu of ``root`` with each ``constexpr int`` of ``sets``
    ("NAME=VALUE") rewritten, built alone into _dev/; the CDLL."""
    import ctypes
    csrc = os.path.join(root, "periodicschurdecompositions_jl_torch", "csrc")
    src = set_constexprs(open(os.path.join(csrc, name + ".cu")).read(), sets, name + ".cu")
    dev = os.path.join(HERE, "_dev")
    os.makedirs(dev, exist_ok=True)
    tag = "_".join(x.replace("=", "") for x in sets)
    cu = os.path.join(dev, f"{name}_{tag}.cu")
    open(cu, "w").write(src)
    subprocess.run([_cuda._find_nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", csrc, "-o",
                    cu[:-3] + ".so", cu], check=True)
    return ctypes.CDLL(cu[:-3] + ".so")


def rg_state(torch, p, n, m, i, S):
    """rg_kernel_phase's state: its problem with the window's boundaries
    deflated and the opening ladder applied (H and Z on the card)."""
    from chip_smoke import mk_rg_problem
    from periodicschurdecompositions_jl_torch.ops import rgopen
    Hn, Zn, rotn = mk_rg_problem(p, n, np.random.default_rng(2026))
    H, Z = torch.tensor(Hn, device="cuda"), torch.tensor(Zn, device="cuda")
    if m > 1:
        H[0, m - 1, m - 2] = 0.0
    if i + 1 < n:
        H[0, i + 1, i] = 0.0
    rgopen.rg_ladder_plain(H, Z, "open", m - 1, i, torch.tensor(rotn, device="cuda"), S,
                           want_z=True)
    return H, Z


def time_rg(torch, lib, _cuda, args, out):
    import ctypes
    from chip_smoke import alternating
    p, n = 8, 256
    libs = {"": lib}
    if args.set:
        libs["_" + "_".join(args.set)] = build_variant(_cuda, args.root, "sweep_rg", args.set)
        out["set"] = args.set
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for lb in libs.values():
        lb.psd_rg_sweep_generate.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
    work = torch.empty((p, n, n), dtype=torch.float64, device="cuda")  # either design's
    log = torch.zeros((p, n, 28), dtype=torch.float64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    out.update(p=p, n=n)
    for sname, S in (("alt", alternating(p)), ("direct", (True,) * p)):
        Sd = torch.tensor([int(x) for x in S], dtype=torch.int32, device="cuda")
        for (m, i) in ((1, n - 1), (38, 200), (121, 124)):
            H0, _ = rg_state(torch, p, n, m, i, S)
            for tag, lb in libs.items():
                def call():
                    _cuda.check(lb.psd_rg_sweep_generate(H0.data_ptr(), work.data_ptr(),
                                                         log.data_ptr(), Sd.data_ptr(), p, n,
                                                         m, i, st), "rg_sweep_generate")
                ms = event_ms(torch, call, args.reps)
                w = f"{sname}[{m},{i}]{tag}"
                out[f"A_ms_{w}"] = ms
                out[f"A_us_per_step_factor_{w}"] = ms * 1e3 / ((i - 1 - m) * p)
                # every entry the kernel writes: L, R, ZR of each factor, r of factor 0
                written = torch.cat([log[:, m:i - 1, :27].reshape(-1), log[0, m:i - 1, 27]])
                out[f"log_sha256_{w}"] = hashlib.sha256(
                    written.cpu().numpy().tobytes()).hexdigest()[:16]
    if args.headline:
        headline_rg(torch, args, out)


def time_deflate(torch, lib, _cuda, args, out):
    import importlib.util
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.ops import pqz_complex, pqz_deflate, pqz_real
    # this checkout's chip_smoke.py (--root's may predate its deflation cases);
    # it drives the port that --root names
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    alternating, cx_draw = cs.alternating, cs.cx_draw
    cx_signed_reduction, pqz_deflate_cases = cs.cx_signed_reduction, cs.pqz_deflate_cases
    out["actions"] = ("csrc/pqz_deflate.cu" if hasattr(pqz_deflate, "launches")
                      else "plain torch")
    S = alternating(8)
    eps = float(np.finfo(np.float64).eps)
    cases = pqz_deflate_cases(rg_reduction(torch, args, out), cx_signed_reduction("cuda"))
    if args.against:
        return deflate_ab(torch, _cuda, pqz_deflate, S, eps, cases, args, out)
    for name, H0, Z0, action, a, zero in cases:
        p, n, _ = H0.shape
        H0 = H0.clone()
        if zero is not None:
            H0[zero[0], zero[1], zero[1]] = 0.0
        cores = pqz_deflate.DeflateCores(p, S, True, eps,
                                         float(np.finfo(np.float64).tiny) * n / eps)
        walls = []
        for _ in range(min(args.reps, 5)):
            H, Z = H0.clone(), Z0.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(cores, f"{action}_core")(H, Z, *a)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        tag = f"{name} {a}"
        out[f"{tag} ms"] = sorted(walls)[len(walls) // 2]
        out[f"{tag} runs ms"] = walls
        out[f"{tag} H, Z sha256"] = [sha(H), sha(Z)]
    if not args.headline:
        return
    headline_rg(torch, args, out)
    headline_cx(torch, out)
    A = torch.tensor(np.random.default_rng(4242).standard_normal((8, 256, 256)), device="cuda")
    for tag, A, core in (("rg", A, pqz_real),
                         ("signed_cx", torch.tensor(cx_draw(8, 128, 777), device="cuda"),
                          pqz_complex)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.pschur(A, "R", S=S)
        torch.cuda.synchronize()
        out[f"{tag}_leg_wall_s"] = time.perf_counter() - t0
        info = core.last_info
        for k in ("iterate_s", "reduce_s", "niter", "czshift"):
            out[f"{tag}_leg_{k}"] = info[k]


def deflate_ab(torch, _cuda, pqz_deflate, S, eps, cases, args, out):
    """Each action through this checkout's library (A) and ``args.against``'s
    (B), swapped in as ``_cuda``'s loaded library, in rounds A, B, B, A."""
    import ctypes
    so = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from periodicschurdecompositions_jl_torch.ops import _cuda; "
         "print(_cuda.load()._name)", os.path.abspath(args.against)],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[-1]
    libs = {"A": _cuda.load(), "B": _cuda._declare(ctypes.CDLL(so))}
    out["A"], out["B"] = libs["A"]._name, so
    for name, H0, Z0, action, a, zero in cases:
        p, n, _ = H0.shape
        H0 = H0.clone()
        if zero is not None:
            H0[zero[0], zero[1], zero[1]] = 0.0
        cores = pqz_deflate.DeflateCores(p, S, True, eps,
                                         float(np.finfo(np.float64).tiny) * n / eps)
        ms, res = {"A": [], "B": []}, {}
        for tag in "ABBA" * args.reps:
            _cuda._lib = libs[tag]
            H, Z = H0.clone(), Z0.clone()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            getattr(cores, f"{action}_core")(H, Z, *a)
            e1.record()
            torch.cuda.synchronize()
            ms[tag].append(e0.elapsed_time(e1))
            res[tag] = [sha(H), sha(Z)]
        _cuda._lib = libs["A"]
        tag = f"{name} {a}"
        out[f"{tag} ms A, B"] = [float(np.median(ms["A"])), float(np.median(ms["B"]))]
        out[f"{tag} H, Z sha256 A, B"] = [res["A"], res["B"]]


def rg_reduction(torch, args, out):
    """The rg leg's signed reduction (p=8, n=256, seed 4242, alternating S),
    kept in the file ``args.hq`` for the next turns."""
    from chip_smoke import alternating
    from periodicschurdecompositions_jl_torch.ops import hessenberg
    p, n = 8, 256
    if os.path.exists(args.hq):
        out["rg_reduce_s"] = "loaded from " + os.path.relpath(args.hq, HERE)
        return tuple(t.cuda() for t in torch.load(args.hq))
    A = torch.tensor(np.random.default_rng(4242).standard_normal((p, n, n)), device="cuda")
    t0 = time.perf_counter()
    H, Q = hessenberg.phessenberg_signed_core(A, alternating(p), want_q=True)
    torch.cuda.synchronize()
    out["rg_reduce_s"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.hq), exist_ok=True)
    torch.save((H.cpu(), Q.cpu()), args.hq)
    return H, Q


def headline_rg(torch, args, out):
    """The real generalized iteration of the rg leg (p=8, n=256, seed 4242,
    alternating S) from its signed reduction, kept in ``args.hq``."""
    from chip_smoke import alternating
    from periodicschurdecompositions_jl_torch.ops import pqz_real, sweep_rg
    S = alternating(8)
    H, Q = rg_reduction(torch, args, out)

    def run():
        return pqz_real.pqz_real_gen_core(H, S, Z=Q, with_info=True)
    T, Z, *_, info = run()  # warm-up
    torch.cuda.synchronize()
    before = sweep_rg.launches["rg_sweep_generate"]
    walls = []
    for _ in range(RG_RUNS):
        t0 = time.perf_counter()
        T, Z, *_, info = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["rg_iterate_s"] = sorted(walls)[len(walls) // 2]
    out["rg_iterate_runs_s"] = walls
    out["rg_niter"] = info["niter"]
    out["rg_sweeps"] = info["sweeps"]
    out["rg_A_launches"] = (sweep_rg.launches["rg_sweep_generate"] - before) / RG_RUNS
    out["rg_T_sha256"], out["rg_Z_sha256"] = sha(T), sha(Z)
    if args.trace:
        trace_rg(torch, run, out, args.trace_out)


def trace_rg(torch, run, out, path):
    """Where the rg iteration's host time goes: a CPU + CUDA torch.profiler
    trace grouped by operation, then cProfile by Python function."""
    import cProfile
    import io
    import pstats
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import dev_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    busy = sum(dev_us(e) for e in ev if "CUDA" in str(e.device_type)) / 1e6
    cpu = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)
    host_ops = sum(e.self_cpu_time_total for e in ev) / 1e6
    out["trace_wall_s"] = wall
    out["trace_device_busy_s"] = busy
    out["trace_host_ops_self_s"] = host_ops
    out["trace_top_host_ops"] = [
        [e.key[:40], e.count, round(e.self_cpu_time_total / 1e3, 3)] for e in cpu[:14]]
    pr = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr.enable()
    run()
    torch.cuda.synchronize()
    pr.disable()
    out["cprofile_wall_s"] = time.perf_counter() - t0
    buf = io.StringIO()
    st = pstats.Stats(pr, stream=buf).sort_stats("tottime")
    st.print_stats(40)
    rows = []
    for (fn, line, name), (cc, nc, tt, ct, _) in sorted(
            st.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:16]:
        rows.append([f"{os.path.basename(fn)}:{line}:{name}"[:60], nc, round(tt, 4)])
    out["cprofile_top_tottime"] = rows
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
        f.write("\n\n" + buf.getvalue())


def hess_draw(p, n, seed, cplx):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((p, n, n))
    return A + 1j * rng.standard_normal((p, n, n)) if cplx else A


def sha(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def build_phase_libs(_cuda, root, sets):
    """hess.cu of ``root`` built with kStagePhases 0 (barriers only), 1
    (generations and barriers) and 2 (everything), each ``constexpr int``
    of ``sets`` ("NAME=VALUE") rewritten, into _dev/; {phases: CDLL}, empty
    when the source has no kStagePhases.  Prints ptxas's report."""
    import ctypes
    csrc = os.path.join(root, "periodicschurdecompositions_jl_torch", "csrc")
    src = open(os.path.join(csrc, "hess.cu")).read()
    line = "constexpr int kStagePhases = 2;"
    if line not in src:
        return {}
    src = set_constexprs(src, sets, "hess.cu")
    dev = os.path.join(HERE, "_dev")
    os.makedirs(dev, exist_ok=True)
    nvcc, libs, procs = _cuda._find_nvcc(), {}, {}
    for k in (0, 1, 2):
        cu = os.path.join(dev, f"hess_phases{k}.cu")
        open(cu, "w").write(src.replace(line, f"constexpr int kStagePhases = {k};"))
        procs[k] = subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", csrc, "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for k, pr in procs.items():
        log = pr.communicate()[0]
        print(f"nvcc hess.cu kStagePhases={k} {' '.join(sets)}: rc {pr.returncode}\n"
              + "\n".join(x for x in log.splitlines() if "Used" in x or "spill" in x))
        if pr.returncode:
            raise SystemExit(log)
        lib = ctypes.CDLL(os.path.join(dev, f"hess_phases{k}.so"))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.psd_hess_reduce, lib.psd_hess_reduce_c128):
            fn.argtypes = [vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
        libs[k] = lib
    return libs


def time_hess(torch, lib, _cuda, args, out):
    import ctypes
    from periodicschurdecompositions_jl_torch.ops import hessenberg
    reps = min(args.reps, 5)
    phase_libs = build_phase_libs(_cuda, args.root, args.set)
    out["set"] = args.set
    for (tag, p, n, seed, cplx) in (("real", 16, 512, 12345, False),
                                    ("c128", 8, 256, 777, True),
                                    ("real_p1n64", 1, 64, 64, False),
                                    ("real_p3n101", 3, 101, 101, False),
                                    ("c128_p1n64", 1, 64, 64, True),
                                    ("c128_p3n101", 3, 101, 101, True)):
        A = torch.tensor(hess_draw(p, n, seed, cplx), device="cuda")
        H, Q = hessenberg.phessenberg_core(A)
        out[f"H_sha256_{tag}"], out[f"Q_sha256_{tag}"] = sha(H), sha(Q)
        if "_" in tag:
            continue
        before = hessenberg.launches["hess_reduce"]
        out[f"hess_ms_{tag}"] = event_ms(torch, lambda: hessenberg.phessenberg_core(A), reps)
        out[f"hess_launches_per_call_{tag}"] = \
            (hessenberg.launches["hess_reduce"] - before) / (reps + 1)
        for k, plib in phase_libs.items():
            Hk = torch.empty_like(A)
            ws = torch.empty(n + 2, dtype=A.dtype, device="cuda")
            entry = plib.psd_hess_reduce_c128 if cplx else plib.psd_hess_reduce
            st = torch.cuda.current_stream().cuda_stream

            def call():
                Hk.copy_(A)
                nl = ctypes.c_int(0)
                _cuda.check(entry(Hk.data_ptr(), Q.data_ptr(), ws.data_ptr(), p, n,
                                  ctypes.byref(nl), st), "hess_reduce phases")
            out[f"hess_ms_{tag}_phases{k}"] = event_ms(torch, call, reps)
            if k == 2:  # H does not depend on Q: the variant's H against the source's
                out[f"H_sha256_{tag}_phases2"] = sha(Hk)
    if args.headline:
        headline_real(torch, out)
        headline_cx(torch, out)


def time_signed(torch, lib, _cuda, args, out):
    import periodicschurdecompositions_jl_torch as pt
    from chip_smoke import alternating
    from periodicschurdecompositions_jl_torch.ops import hessenberg, pqz_complex, pqz_real
    kernel = hasattr(hessenberg, "signed_stage2_cuda")
    out["stage2"] = "csrc/hess_signed.cu" if kernel else "plain torch"
    hessenberg.phessenberg_signed_core(torch.tensor(hess_draw(4, 8, 1, False), device="cuda"),
                                       alternating(4))  # warm-up: the build, the signature
    reduce = hessenberg.phessenberg_signed_core
    split_libs = build_signed_variants(_cuda, args.root) if args.split and kernel else {}
    for (tag, p, n, seed, cplx) in (("rg", 8, 256, 4242, False), ("cx", 8, 128, 777, True)):
        S = alternating(p)
        A = torch.tensor(hess_draw(p, n, seed, cplx), device="cuda")
        A0, scale = A.clone(), float(A.abs().max())
        kept = {"s": []}

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = reduce(*a, **k)
            torch.cuda.synchronize()
            kept["s"].append(time.perf_counter() - t0)
            kept["HQ"] = tuple(t.clone() for t in res)  # the caller may work in place
            return res
        if args.headline:
            hessenberg.phessenberg_signed_core = timed
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                P = pt.pschur(A, "R", S=S)
                torch.cuda.synchronize()
                out[f"{tag}_leg_wall_s"] = time.perf_counter() - t0
            finally:
                hessenberg.phessenberg_signed_core = reduce
            out[f"{tag}_leg_input_unchanged"] = bool(torch.equal(A, A0))
            A = A0
            info = (pqz_complex if cplx else pqz_real).last_info
            out[f"{tag}_leg_iterate_s"] = info["iterate_s"]
            out[f"{tag}_leg_niter"] = info["niter"]
            out[f"{tag}_values_sha256"] = sha(P.values)
        else:
            timed(A, S)
        H, Q = kept["HQ"]
        out[f"{tag}_H_sha256"], out[f"{tag}_Q_sha256"] = sha(H), sha(Q)
        ref = os.path.join(HERE, "_dev", f"signed_plain_{tag}.pt")
        if not kernel:
            out[f"{tag}_reduce_s"] = kept["s"][0]
            os.makedirs(os.path.dirname(ref), exist_ok=True)
            torch.save((H.cpu(), Q.cpu()), ref)
            continue
        for _ in range(min(args.reps, 5) - 1):
            timed(A, S)
        out[f"{tag}_reduce_s"] = sorted(kept["s"])[len(kept["s"]) // 2]
        out[f"{tag}_reduce_runs_s"] = kept["s"]
        if os.path.exists(ref):
            Hp, Qp = (t.cuda() for t in torch.load(ref))
            out[f"{tag}_plain_from"] = os.path.relpath(ref, HERE)
        else:
            Hp, Qp = hessenberg.phessenberg_signed_core_plain(A, S)
            out[f"{tag}_plain_from"] = "phessenberg_signed_core_plain"
        out[f"{tag}_plain_H_sha256"] = sha(Hp)
        Hn, Hpn, Qn, Qpn = (t.cpu().numpy() for t in (H, Hp, Q, Qp))
        out[f"{tag}_dH_vs_plain"] = float(np.abs(Hn - Hpn).max()) / scale
        out[f"{tag}_dQ_vs_plain"] = float(np.abs(Qn - Qpn).max())
        out[f"{tag}_H_entries_differing"] = int((Hn != Hpn).sum())
        from periodicschurdecompositions_jl_torch.ops import sweep_cx
        H1, Q1 = hessenberg._signed_stage1(A, S, True)
        sig = sweep_cx._signature(S, A.device)
        ts = []
        for _ in range(min(args.reps, 5) + 1):
            Hc, Qc = H1.clone(), Q1.clone()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            hessenberg.signed_stage2_cuda(Hc, Qc, sig)
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        out[f"{tag}_stage2_ms"] = sorted(ts[1:])[len(ts[1:]) // 2]
        out[f"{tag}_stage2_runs_ms"] = ts[1:]
        for name, vlib in split_libs.items():
            for want_q in (True, False):
                out[f"{tag}_stage2_ms_{name}{'' if want_q else '_no_q'}"] = \
                    time_signed_variant(torch, _cuda, vlib, H1, Q1 if want_q else None, sig,
                                        min(args.reps, 5))


# Copies of hess_signed.cu for --split: the generations replaced by the
# identity rotation, or every batched chain of updates cut off (the data then
# differ, so a generation may take a shorter branch: an attribution, not an
# exact split).
SIGNED_VARIANTS = {
    "source": [],
    "no_generations": [("psd::givens_r(f, g, c, s, r);", "c = 1.0; s = 0.0; r = f;"),
                       ("psd::givens_cx(f, g, c, s, r);",
                        "c = 1.0; s = make_double2(0.0, 0.0); r = f;")],
    "no_chains": [("  T b = e[(size_t)ihi * stride];\n  for (int i0",
                   "  T b = e[(size_t)ihi * stride];\n  if (ihi >= 0) return b;\n  for (int i0")],
}


def build_signed_variants(_cuda, root):
    """hess_signed.cu of ``root`` built as each of SIGNED_VARIANTS into
    _dev/; {name: CDLL}.  Prints ptxas's register and spill report."""
    import ctypes
    csrc = os.path.join(root, "periodicschurdecompositions_jl_torch", "csrc")
    src = open(os.path.join(csrc, "hess_signed.cu")).read()
    dev = os.path.join(HERE, "_dev")
    os.makedirs(dev, exist_ok=True)
    nvcc, procs, libs = _cuda._find_nvcc(), {}, {}
    for name, subs in SIGNED_VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"--split: {old!r} not in hess_signed.cu")
            text = text.replace(old, new)
        cu = os.path.join(dev, f"hess_signed_{name}.cu")
        open(cu, "w").write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", csrc, "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, pr in procs.items():
        log = pr.communicate()[0]
        print(f"nvcc hess_signed.cu {name}: rc {pr.returncode}\n"
              + "\n".join(x for x in log.splitlines() if "Used" in x or "spill" in x))
        if pr.returncode:
            raise SystemExit(log)
        lib = ctypes.CDLL(os.path.join(dev, f"hess_signed_{name}.so"))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.psd_hess_signed, lib.psd_hess_signed_c128):
            fn.argtypes = [vp, vp, vp, vp, i32, i32, ctypes.POINTER(i32), vp]
            fn.restype = i32
        lib.psd_hess_signed_scratch.argtypes = [i32, i32]
        lib.psd_hess_signed_scratch.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def time_signed_variant(torch, _cuda, lib, H1, Q1, sig, reps):
    """Median CUDA-event time of stage 2 through ``lib``'s entry on copies
    of stage 1's output (Q1 None: no Q), after a warm-up."""
    import ctypes
    p, n, _ = H1.shape
    cx = H1.is_complex()
    entry = lib.psd_hess_signed_c128 if cx else lib.psd_hess_signed
    ws = torch.empty(lib.psd_hess_signed_scratch(n, int(cx)), dtype=torch.uint8,
                     device=H1.device)
    st = torch.cuda.current_stream().cuda_stream
    ts = []
    for _ in range(reps + 1):
        H = H1.clone()
        QT = None if Q1 is None else Q1.transpose(1, 2).contiguous()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        nl = ctypes.c_int(0)
        e0.record()
        rc = entry(H.data_ptr(), None if QT is None else QT.data_ptr(), sig.data_ptr(),
                   ws.data_ptr(), p, n, ctypes.byref(nl), st)
        e1.record()
        torch.cuda.synchronize()
        _cuda.check(rc, "hess_signed variant")
        ts.append(e0.elapsed_time(e1))
    return sorted(ts[1:])[len(ts[1:]) // 2]


if __name__ == "__main__":
    sys.exit(main())
