#!/usr/bin/env python3
"""CPU checks of the port's iteration cores (no card, no JAX).

  python3 scripts/cpu_core_checks.py residuals
      The real core (``pqr_real_core``) and the AED driver
      (``pqr_real_core_aed`` with ``aed_window=12, aed_interval=8``: one
      bulge, two bulges, ``host_tail=10``) on the p=3 n=40 draws
      ``default_rng(seed).standard_normal((3, 40, 40))``, seeds 70 and 0-3:
      iterations, ``check_psd`` residual and orthonormality in eps.

  python3 scripts/cpu_core_checks.py dump OUT.npz [--root DIR]
      Runs ``pqz_real_gen_core`` and ``pqz_complex_core`` (the package under
      DIR, default this checkout) on eleven Hessenberg-triangular CPU cases
      with mixed signatures (planted zeros for DEFLATE_POS / DEFLATE_NEG, a
      p=8 n=40 case that takes CZSHIFT, want_z=False) and a signed
      reduction plus the rg core at p=4 n=24, and saves every output.

  python3 scripts/cpu_core_checks.py compare A.npz B.npz
      Bit-for-bit comparison of two dumps (``np.array_equal`` on each array):
      the check that a refactor leaves the cores' results unchanged.
"""
import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = float(np.finfo(np.float64).eps)
SEEDS = (70, 0, 1, 2, 3)
CASES = [  # (p, n, S, complex, planted zero diagonals (l, j), want_z)
    (3, 20, (1, 0, 1), False, (), True),
    (4, 17, (1, 0, 0, 1), False, (), True),
    (2, 12, (1, 1), False, (), True),
    (3, 16, (1, 0, 1), False, ((1, 5), (2, 9)), True),
    (8, 40, (1, 0) * 4, False, (), True),
    (3, 15, (1, 0, 1), False, (), False),
    (3, 20, (1, 0, 1), True, (), True),
    (2, 24, (1, 1), True, (), True),
    (4, 16, (1, 0, 0, 1), True, ((1, 4), (2, 8)), True),
    (8, 40, (1, 0) * 4, True, (), True),
    (3, 15, (1, 1, 0), True, (), False),
]


def residuals():
    import torch
    import periodicschurdecompositions_jl_torch as pt
    from periodicschurdecompositions_jl_torch.config import AlgoConfig
    from periodicschurdecompositions_jl_torch.ops import pqr_real
    from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_core
    runs = {"core": None,
            "aed": AlgoConfig(aed_window=12, aed_interval=8),
            "aed nbulges=2": AlgoConfig(aed_window=12, aed_interval=8, nbulges=2),
            "aed host_tail=10": AlgoConfig(aed_window=12, aed_interval=8, host_tail=10)}
    for seed in SEEDS:
        A = np.random.default_rng(seed).standard_normal((3, 40, 40))
        H, Q = phessenberg_core(torch.tensor(A))
        for name, cfg in runs.items():
            if cfg is None:
                T, Z, wr, wi, ok, info = pqr_real.pqr_real_core(H, Z=Q, with_info=True)
            else:
                T, Z, wr, wi, ok, info = pqr_real.pqr_real_core_aed(H, Z=Q, cfg=cfg,
                                                                    with_info=True)
            P = pt.PeriodicSchur(Ts=T, Zs=Z, values=torch.complex(torch.tensor(wr),
                                                                  torch.tensor(wi)))
            _, rep = pt.check_psd(P, A, qtol=10.0, tol=32.0)
            print(f"seed {seed} {name}: converged {ok}, niter {info['niter']}, residual "
                  f"{rep['residual_rel'] / EPS:.1f} eps, orthonormality "
                  f"{rep['orthonormality'] / EPS:.1f} eps")


def dump(out, root):
    sys.path.insert(0, root)
    import torch
    from periodicschurdecompositions_jl_torch.ops.hessenberg import phessenberg_signed_core
    from periodicschurdecompositions_jl_torch.ops.pqz_complex import pqz_complex_core
    from periodicschurdecompositions_jl_torch.ops.pqz_real import pqz_real_gen_core
    arrays = {}
    for k, (p, n, S, cplx, zeros, want_z) in enumerate(CASES):
        rng = np.random.default_rng(100 + k)

        def m():
            x = rng.standard_normal((n, n))
            return x + 1j * rng.standard_normal((n, n)) if cplx else x
        H = np.stack([np.triu(m(), -1 if l == 0 else 0) for l in range(p)])
        for l, j in zeros:
            H[l, j, j] = 0.0
        S = tuple(bool(x) for x in S)
        core = pqz_complex_core if cplx else pqz_real_gen_core
        T, Z, *vals, ok, info = core(torch.tensor(H), S, want_z=want_z, with_info=True)
        arrays[f"c{k}_T"] = T.numpy()
        if Z is not None:
            arrays[f"c{k}_Z"] = Z.numpy()
        for i, v in enumerate(vals):
            arrays[f"c{k}_v{i}"] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
        arrays[f"c{k}_ok"] = np.array(ok)
        arrays[f"c{k}_info"] = np.array(str(info))
        print(f"case {k}: p={p} n={n} S={S} complex={cplx}: converged {ok}, niter "
              f"{info['niter']}, czshift {info['czshift']}, deflate_pos "
              f"{info['deflate_pos']}, deflate_neg {info['deflate_neg']}")
    S4 = (True, False, True, False)
    A = torch.tensor(np.random.default_rng(7).standard_normal((4, 24, 24)))
    H, Q = phessenberg_signed_core(A, S4)
    T, Z, ar, ai, be, sc, ok, info = pqz_real_gen_core(H, S4, Z=Q, with_info=True)
    arrays.update(red_T=T.numpy(), red_Z=Z.numpy(), red_ar=ar, red_ai=ai,
                  red_niter=np.array(info["niter"]))
    np.savez(out, **arrays)
    print(f"{len(arrays)} arrays to {out}")


def compare(a, b):
    A, B = np.load(a), np.load(b)
    if sorted(A.files) != sorted(B.files):
        print("the dumps hold different arrays")
        return 1
    bad = [k for k in A.files if not np.array_equal(A[k], B[k])]
    print(f"{len(A.files)} arrays, {len(bad)} differing: {bad}")
    return 1 if bad else 0


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("residuals")
    d = sub.add_parser("dump")
    d.add_argument("out")
    d.add_argument("--root", default=HERE)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    if args.cmd == "residuals":
        sys.path.insert(0, HERE)
        residuals()
        return 0
    if args.cmd == "dump":
        dump(args.out, os.path.abspath(args.root))
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
