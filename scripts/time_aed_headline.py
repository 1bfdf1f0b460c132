#!/usr/bin/env python3
"""A leg with and without aggressive early deflation (AED) and the
host-tail finish, in paired turns on one CUDA card.

By default the real headline: its draw (p=16, n=512,
``default_rng(12345).standard_normal``) goes through ``pschur(A, 'R')`` (the
default configuration: AED and the host tail; leg "on") and through
``pschur_real_pipeline(A, 'R', cfg=AlgoConfig(aed=False, host_tail=-1))``
(leg "off").  ``--rg``: the real generalized leg of ``chip_smoke.py`` (p=8,
n=256, ``default_rng(4242)``, alternating S) through ``pschur(A, 'R', S)``
and ``pschur_real_gen_pipeline``; ``--cx``: its complex leg (p=8, n=256,
``default_rng(777)``, S=None) through ``pschur(C, 'R')`` and
``pschur_complex_pipeline``.  The legs run in ``--pairs`` pairs (default 3)
whose order flips from pair to pair.  Each run is made twice: on the host clock (wall,
reduction, iteration, niter, sweeps, the AED tallies and host seconds, the
backward error, hashes of T and Z; with AED also each analysis: its window
size, beta, deflations and host seconds, split into the window Schur, the
failed-block moves and the re-reduction of the window on the card), and under ``torch.profiler``
(device time and launches by kernel, device busy time and the idle share
of that run's wall).

``--want-t``: the legs are the same ``pschur`` call with T (leg "T", the
default) and without it (leg "noT", ``want_t=False``), both with AED and
the host tail; ``--no-z`` takes ``want_z=False`` in both.  The run fails
unless the two legs agree bit for bit in niter, the AED tallies, the
eigenvalues and Z; the profile adds the cuBLAS products (``gemm``: the AED
apply's and the repair chain's).

Prints the card's name and power limit first, a line per run, and a JSON
summary last; the whole record goes to ``chiprun_out/time_aed_headline.json``.
With ``--rg`` and ``--cx`` the file is ``time_aed_headline_rg.json`` or
``time_aed_headline_cx.json`` beside it; with ``--want-t`` the files are
``time_want_t[_rg|_cx][_noz].json``.

Run from the repository root:
  python3 scripts/time_aed_headline.py [--rg | --cx] [--pairs K] [--want-t [--no-z]]
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
KERNELS = {
    "real": (("A", "sweep_generate_kernel"), ("B0", "sweep_left_kernel"),
             ("B", "sweep_right_kernel"), ("D", "deflate2x2"), ("G", "glue_kernel"),
             ("reduction", "hess_reduce_kernel")),
    "rg": (("A", "rg_generate_kernel"), ("B0", "rg_left_kernel"), ("B", "rg_right_kernel"),
           ("R", "rg_ladder"), ("CZSHIFT", "czshift_kernel"),
           ("signed", "hess_signed_kernel")),
    "cx": (("A", "qz_generate_kernel"), ("B0", "qz_left_kernel"), ("B", "qz_right_kernel"),
           ("S", "qz_shift_kernel"), ("reduction", "hess_reduce_kernel"),
           ("signed", "hess_signed_kernel")),
}


def sha(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def dev_us(e):
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    route = ap.add_mutually_exclusive_group()
    route.add_argument("--rg", action="store_true", help="the real generalized leg")
    route.add_argument("--cx", action="store_true", help="the complex leg")
    ap.add_argument("--want-t", action="store_true", help="legs with and without T")
    ap.add_argument("--no-z", action="store_true", help="--want-t legs without Z")
    args = ap.parse_args()
    wz = not args.no_z
    kind = "rg" if args.rg else "cx" if args.cx else "real"
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("time_aed_headline: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch import native
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import _cuda, aed, pqr_real, pqz_complex, pqz_real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.load()
    native.load()
    pt.pschur(torch.tensor(np.random.default_rng(0).standard_normal((2, 32, 32)),
                           device="cuda"), "R")
    off = AlgoConfig(aed=False, host_tail=-1)
    if kind == "real":
        An, S = np.random.default_rng(12345).standard_normal((16, 512, 512)), None
        A = torch.tensor(An, device="cuda")
        core = pqr_real
        legs = {"on": lambda: pt.pschur(A, "R"),
                "off": lambda: pqr_real.pschur_real_pipeline(A, "R", cfg=off)}
        if args.want_t:
            legs = {"T": lambda: pt.pschur(A, "R", want_z=wz),
                    "noT": lambda: pt.pschur(A, "R", want_t=False, want_z=wz)}
    elif kind == "rg":
        An, S = cs.rg_draw(cs.P_RG, cs.N_RG, cs.SEED_RG)
        A = torch.tensor(An, device="cuda")
        core = pqz_real
        legs = {"on": lambda: pt.pschur(A, "R", S=S),
                "off": lambda: pqz_real.pschur_real_gen_pipeline(A, S, "R", cfg=off)}
        if args.want_t:
            legs = {"T": lambda: pt.pschur(A, "R", S=S, want_z=wz),
                    "noT": lambda: pt.pschur(A, "R", S=S, want_t=False, want_z=wz)}
    else:
        An, S = cs.cx_draw(cs.P_CX, cs.N_CX, cs.SEED_CX), None
        A = torch.tensor(An, device="cuda")
        core = pqz_complex
        legs = {"on": lambda: pt.pschur(A, "R"),
                "off": lambda: pqz_complex.pschur_complex_pipeline(A, (True,) * cs.P_CX, "R",
                                                                   cfg=off)}
        if args.want_t:
            legs = {"T": lambda: pt.pschur(A, "R", want_z=wz),
                    "noT": lambda: pt.pschur(A, "R", want_t=False, want_z=wz)}
    kernels = KERNELS[kind] + ((("gemm", "gemm"),) if args.want_t else ())
    from periodicschurdecompositions_jl_torch.models import ordschur as ordmod
    events = []
    parts = {}
    names = {"real": ("aed_analyze", "_window_schur", "_phess_window"),
             "rg": ("aed_analyze_rg", "_window_rgpsd", "_phess_window_signed"),
             "cx": ("aed_analyze_cx", "_window_gpsd", "_phess_window_signed")}[kind]
    originals = {"analyze": getattr(aed, names[0]), "schur": getattr(aed, names[1]),
                 "phess": getattr(aed, names[2]), "ordschur": ordmod.ordschur}

    def timed(key, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
        return call

    def timed_analyze(Hwin, *a, **k):
        parts.clear()
        t0 = time.perf_counter()
        res = originals["analyze"](Hwin, *a, **k)
        beta = a[0] if kind == "real" else a[1]
        events.append({"w": int(Hwin.shape[-1]), "beta": abs(beta),
                       "d": 0 if res is None else int(res[0]),
                       "s": time.perf_counter() - t0, **parts})
        return res

    setattr(aed, names[0], timed_analyze)
    setattr(aed, names[1], timed("schur", originals["schur"]))
    ordmod.ordschur = timed("moves", originals["ordschur"])
    setattr(aed, names[2], timed("phess", originals["phess"]))
    order = ["T", "noT"] if args.want_t else ["on", "off"]
    for leg in order:  # warm-up: the first run of a leg loads the libraries it calls
        legs[leg]()
    events.clear()
    out = {"card": smi, "leg": kind, "pairs": args.pairs, "runs": []}
    for k in range(args.pairs):
        for leg in (order if k % 2 == 0 else order[::-1]):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            P = legs[leg]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            info = dict(core.last_info)
            T = P.Ts.cpu().numpy()
            Z = None if P.Zs is None else P.Zs.cpu().numpy()
            valid = leg != "noT" and Z is not None  # T and Z reconstruct A
            run = {"pair": k, "leg": leg, "wall_s": wall,
                   "reduce_s": info["reduce_s"], "iterate_s": info["iterate_s"],
                   "niter": info["niter"], "sweeps": info["sweeps"],
                   **{key: info[key] for key in ("sweep_steps", "czshift") if key in info},
                   **{key: info[key] for key in ("aed_events", "aed_hits", "aed_deflated",
                                                 "host_tail_finished", "aed_s")},
                   "backerr": (None if not valid else cs.backerr(An, T, Z)
                               if S is None and kind == "real"
                               else cs.cx_backerr(An, T, Z, S or (True,) * An.shape[0])),
                   "T": sha(P.Ts), "Z": None if Z is None else sha(P.Zs),
                   "values": sha(P.values), "analyses": list(events)}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                legs[leg]()
                torch.cuda.synchronize()
                pwall = time.perf_counter() - t0
            ev = [e for e in prof.key_averages()
                  if "CUDA" in str(e.device_type) and dev_us(e) > 0]
            busy = sum(dev_us(e) for e in ev) / 1e3
            run.update({"profiled_wall_s": pwall, "device_ms": busy,
                        "idle_share": 1 - busy / (pwall * 1e3)})
            named = 0.0
            for tag, key in kernels:
                sel = [e for e in ev if key in e.key]
                ms = sum(dev_us(e) for e in sel) / 1e3
                named += ms
                run[f"{tag}_ms"] = ms
                run[f"{tag}_launches"] = sum(e.count for e in sel)
            run["other_ms"] = busy - named
            out["runs"].append(run)
            print(f"pair {k} {leg}: " + ", ".join(
                f"{a} {b:.6g}" if isinstance(b, float) else f"{a} {b}"
                for a, b in run.items() if a != "analyses"), flush=True)
            for e in run["analyses"]:
                print(f"    analysis w={e['w']} beta={e['beta']:.3e} d={e['d']} "
                      f"{e['s'] * 1e3:.1f} ms (window Schur "
                      f"{e.get('schur', 0) * 1e3:.1f}, moves {e.get('moves', 0) * 1e3:.1f}, "
                      f"re-reduction {e.get('phess', 0) * 1e3:.1f} ms)", flush=True)
    for key, name in zip(("analyze", "schur", "phess"), names):
        setattr(aed, name, originals[key])
    ordmod.ordschur = originals["ordschur"]
    summary = {"card": smi, "leg": kind}
    for leg in order:
        rs = [r for r in out["runs"] if r["leg"] == leg]
        for key in ("wall_s", "iterate_s", "device_ms", "idle_share", "aed_s", "A_ms"):
            v = [r[key] for r in rs]
            summary[f"{leg} {key} median"] = float(np.median(v))
            summary[f"{leg} {key} spread"] = [min(v), max(v)]
        for key in ("niter", "sweeps", "aed_events", "aed_deflated", "host_tail_finished",
                    "backerr", "T", "Z", "values"):
            summary[f"{leg} {key}"] = sorted({r[key] for r in rs}, key=str)
        for tag, _ in kernels[1:3] + kernels[3:4] + kernels[-1:]:
            v = [r[f"{tag}_ms"] for r in rs]
            summary[f"{leg} {tag}_ms median"] = float(np.median(v))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    suffix = "" if kind == "real" else f"_{kind}"
    name = (f"time_want_t{suffix}{'_noz' if args.no_z else ''}" if args.want_t
            else f"time_aed_headline{suffix}")
    with open(os.path.join(HERE, "chiprun_out", f"{name}.json"), "w") as f:
        json.dump({**out, "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    if args.want_t:
        # without T the iteration reads the numbers it reads with T
        for key in ("niter", "sweeps", "aed_events", "aed_deflated", "host_tail_finished",
                    "Z", "values"):
            if summary[f"T {key}"] != summary[f"noT {key}"] or len(summary[f"T {key}"]) != 1:
                print(f"time_aed_headline: the legs differ in {key}", file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
