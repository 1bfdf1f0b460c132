#!/usr/bin/env python3
"""Time kernel A (csrc/sweep.cu::psd_sweep_generate) on one CUDA card.

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

Run from the repository root:  python3 scripts/time_sweep_generate.py [--root DIR]
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
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)
    import torch
    if not torch.cuda.is_available():
        print("time_sweep_generate: no CUDA device", file=sys.stderr)
        return 2
    from periodicschurdecompositions_jl_torch.ops import _cuda
    from chip_smoke import mk_sweep_problem
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = _cuda.load()
    p, n = 16, 512
    N = n + 1
    Hn, _, v0 = mk_sweep_problem(p, n, np.random.default_rng(2024))
    H = torch.tensor(Hn, device="cuda")
    work = torch.empty((p, N, N), dtype=torch.float64, device="cuda")
    R = torch.empty((p, N, 9), dtype=torch.float64, device="cuda")
    st = torch.cuda.current_stream().cuda_stream
    out = {"root": os.path.abspath(args.root), "card": smi, "p": p, "n": n}
    for (m, i) in ((0, n - 1), (37, 300), (200, 202)):
        def call():
            _cuda.check(lib.psd_sweep_generate(H.data_ptr(), work.data_ptr(), R.data_ptr(),
                                               p, N, m, i, *map(float, v0), st),
                        "sweep_generate")
        call()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            call()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / args.reps
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
