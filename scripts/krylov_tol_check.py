#!/usr/bin/env python3
"""How ``partial_pschur``'s default ``tol`` locks on the Krylov cell's
construction (host run, CPU tensors).

The construction of benchmarks/probe_krylov_chip.py with q = I (the Krylov
process is invariant under the shared orthogonal q up to the start vector,
and q = I keeps the draw cheap at large n): A_l = T_l upper triangular,
0.05 upper noise, diagonal 1.02 ** arange(n), p=4, nev=4, LM.  For each of
``--starts`` start vectors (``u1`` from default_rng(100 + s)) it runs
``partial_pschur`` with the default tol and with ``tol=0`` and prints the
largest error of the four Ritz values relative to the construction's top
value, nprods and nconverged.

The convergence test compares a slot's residual with tol |lambda| of the
product, 1.02^(3n) times the factors' scale here, so with the default tol
every Ritz value locks after the first restart; tol=0 leaves the
eps^(2/3) ||T|| floor as the criterion.

Usage: python3 scripts/krylov_tol_check.py [--n 4096] [--starts 12]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import periodicschurdecompositions_jl_torch as pt  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--starts", type=int, default=12)
    args = ap.parse_args()
    p, nev, n = 4, 4, args.n
    rng = np.random.default_rng(11)
    A = []
    for _ in range(p):
        T = np.triu(rng.standard_normal((n, n)) * 0.05)
        np.fill_diagonal(T, 1.02 ** np.arange(n))
        A.append(T)
    A = torch.tensor(np.stack(A))
    lam = np.sort((1.02 ** np.arange(n)) ** p)[-nev:]
    out = {}
    for tol in (None, 0.0):
        runs = []
        for s in range(args.starts):
            u = np.random.default_rng(100 + s).standard_normal(n)
            ps, h = pt.partial_pschur(A, nev, "LM", u1=u, tol=tol)
            top = np.sort(np.abs(ps.values.numpy()))[-nev:]
            runs.append({"err": float(np.abs(top - lam).max() / lam.max()),
                         "nprods": h.nprods, "nconverged": h.nconverged})
        errs = [r["err"] for r in runs]
        key = "default" if tol is None else f"tol={tol}"
        out[key] = {"runs": runs, "beyond_1e-6": sum(e > 1e-6 for e in errs),
                    "max_err": max(errs)}
        print(f"{key}: {out[key]['beyond_1e-6']} of {args.starts} start vectors beyond "
              f"1e-6, largest error {max(errs):.3e}, nprods "
              f"{sorted({r['nprods'] for r in runs})}", flush=True)
    print(json.dumps({"n": n, "p": p, "nev": nev, "host": "cpu", **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
