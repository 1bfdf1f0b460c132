#!/usr/bin/env python3
"""The real headline with and without aggressive early deflation (AED) and
the host-tail finish, in paired turns on one CUDA card.

The headline draw (p=16, n=512, ``default_rng(12345).standard_normal``)
goes through ``pschur(A, 'R')`` (the default configuration: AED and the
host tail; leg "on") and through ``pschur_real_pipeline(A, 'R',
cfg=AlgoConfig(aed=False, host_tail=-1))`` (leg "off"), in ``--pairs``
pairs (default 3) whose order flips from pair to pair.  Each run is made twice: on the host clock (wall,
reduction, iteration, niter, sweeps, the AED tallies and host seconds, the
backward error, hashes of T and Z; with AED also each analysis: its window
size, beta, deflations and host seconds, split into the window Schur, the
failed-block moves and the re-reduction of the window on the card), and under ``torch.profiler``
(device time and launches by kernel, device busy time and the idle share
of that run's wall).

Prints the card's name and power limit first, a line per run, and a JSON
summary last; the whole record goes to ``chiprun_out/time_aed_headline.json``.

Run from the repository root:
  python3 scripts/time_aed_headline.py [--pairs K]
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
KERNELS = (("A", "sweep_generate_kernel"), ("B0", "sweep_left_kernel"),
           ("B", "sweep_right_kernel"), ("D", "deflate2x2"), ("G", "glue_kernel"),
           ("reduction", "hess_reduce_kernel"))


def sha(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def dev_us(e):
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
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
    from periodicschurdecompositions_jl_torch.ops import _cuda, aed, pqr_real
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.load()
    native.load()
    pt.pschur(torch.tensor(np.random.default_rng(0).standard_normal((2, 32, 32)),
                           device="cuda"), "R")
    An = np.random.default_rng(12345).standard_normal((16, 512, 512))
    A = torch.tensor(An, device="cuda")
    off = AlgoConfig(aed=False, host_tail=-1)
    legs = {"on": lambda: pt.pschur(A, "R"),
            "off": lambda: pqr_real.pschur_real_pipeline(A, "R", cfg=off)}
    from periodicschurdecompositions_jl_torch.models import ordschur as ordmod
    events = []
    parts = {}
    originals = {"analyze": aed.aed_analyze, "schur": aed._window_schur,
                 "phess": aed._phess_window, "ordschur": ordmod.ordschur}

    def timed(key, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
        return call

    def timed_analyze(Hwin, beta, *a, **k):
        parts.clear()
        t0 = time.perf_counter()
        res = originals["analyze"](Hwin, beta, *a, **k)
        events.append({"w": int(Hwin.shape[-1]), "beta": float(beta),
                       "d": 0 if res is None else int(res[0]),
                       "s": time.perf_counter() - t0, **parts})
        return res

    aed.aed_analyze = timed_analyze
    aed._window_schur = timed("schur", originals["schur"])
    ordmod.ordschur = timed("moves", originals["ordschur"])
    aed._phess_window = timed("phess", originals["phess"])
    order = ["on", "off"]
    out = {"card": smi, "pairs": args.pairs, "runs": []}
    for k in range(args.pairs):
        for leg in (order if k % 2 == 0 else order[::-1]):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            P = legs[leg]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            info = dict(pqr_real.last_info)
            run = {"pair": k, "leg": leg, "wall_s": wall,
                   "reduce_s": info["reduce_s"], "iterate_s": info["iterate_s"],
                   "niter": info["niter"], "sweeps": info["sweeps"],
                   "sweep_steps": info["sweep_steps"],
                   **{key: info[key] for key in ("aed_events", "aed_hits", "aed_deflated",
                                                 "host_tail_finished", "aed_s")},
                   "backerr": cs.backerr(An, P.Ts.cpu().numpy(), P.Zs.cpu().numpy()),
                   "T": sha(P.Ts), "Z": sha(P.Zs), "analyses": list(events)}
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
            for tag, key in KERNELS:
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
    aed.aed_analyze, aed._window_schur = originals["analyze"], originals["schur"]
    aed._phess_window, ordmod.ordschur = originals["phess"], originals["ordschur"]
    summary = {"card": smi}
    for leg in order:
        rs = [r for r in out["runs"] if r["leg"] == leg]
        for key in ("wall_s", "iterate_s", "device_ms", "idle_share", "aed_s", "A_ms"):
            v = [r[key] for r in rs]
            summary[f"{leg} {key} median"] = float(np.median(v))
            summary[f"{leg} {key} spread"] = [min(v), max(v)]
        for key in ("niter", "sweeps", "aed_events", "aed_deflated", "host_tail_finished",
                    "backerr", "T"):
            summary[f"{leg} {key}"] = sorted({r[key] for r in rs})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "time_aed_headline.json"), "w") as f:
        json.dump({**out, "summary": summary}, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
