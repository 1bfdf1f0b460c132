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

Run from the repository root:
  python3 scripts/time_sweep_generate.py [--cx] [--root DIR] [--headline]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--headline", action="store_true")
    ap.add_argument("--cx", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
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
    (time_cx if args.cx else time_real)(torch, lib, _cuda, args, out)
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
        import periodicschurdecompositions_jl_torch as pt
        from periodicschurdecompositions_jl_torch.ops import pqr_real
        pt.pschur(torch.tensor(np.random.default_rng(0).standard_normal((2, 32, 32)),
                               device="cuda"), "R")
        A = torch.tensor(np.random.default_rng(12345).standard_normal((16, 512, 512)),
                         device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.pschur(A, "R")
        torch.cuda.synchronize()
        out["headline_wall_s"] = time.perf_counter() - t0
        out["headline_niter"] = pqr_real.last_info["niter"]


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
        import periodicschurdecompositions_jl_torch as pt
        from periodicschurdecompositions_jl_torch.ops import pqz_complex
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


if __name__ == "__main__":
    sys.exit(main())
